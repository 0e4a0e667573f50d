"""The port's engine over byte pools (int8 with per-head scales, and
float8_e4m3fn) against the JAX package's engine, and the byte pools' engine
contract: half the bytes a page, ``set_kv_scales``, spec decode.

Parity: one module-scoped JAX run serves the same requests with an int8
pool and then an e4m3 pool (Pallas in interpret mode), with the same
float32 parameters as the port's engine on the CPU; greedy tokens must be
identical, across a prompt longer than the one prefill bucket (chunked
prefill) and a page crossing.  The counterparts of
tests/test_int8_kv.py's and tests/test_quantized_kv.py's engine tests.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu.engine import EngineConfig as JEngineConfig
from kvcached_tpu.engine import LLMEngine as JLLMEngine
from kvcached_tpu.engine import SamplingParams as JSamplingParams
from kvcached_tpu.models.llama import LlamaConfig as JLlamaConfig
from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.llama import LlamaConfig
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_fast_compile, numpy_jax_params

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ECFG = dict(max_batch=2, max_model_len=64, page_tokens=32, decode_horizon=4,
            prefill_buckets=(32,), num_pages=8, adaptive_horizon=False)
MODES = ("int8", "float8_e4m3fn")
#: a 40-token prompt (two 32-token chunks) and a short one
PROMPTS = [[int(t) for t in np.random.default_rng(0).integers(0, 512, 40)],
           [3, 1, 4, 1, 5]]
NEW = 6


def _engine(cfg, params, **kw):
    return LLMEngine(cfg, EngineConfig(**{**ECFG, **kw}), params=params, device="cpu")


def _serve(eng, prompts=PROMPTS, new=NEW):
    try:
        return [o.output_tokens for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=new))]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def served():
    """The JAX engine's greedy tokens with each byte pool, and the shared
    float32 params."""
    jcfg = JLlamaConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_params(jcfg)
    want = {}
    for mode in MODES:
        eng = JLLMEngine(jcfg, JEngineConfig(interpret=True, kv_dtype=mode, **ECFG),
                         params=jparams)
        try:
            with jax_fast_compile():
                want[mode] = [o.output_tokens for o in eng.generate(
                    PROMPTS, JSamplingParams(max_new_tokens=NEW))]
        finally:
            eng.shutdown()
    cfg = LlamaConfig.toy(dtype="float32")
    return cfg, params_from_jax(tree, cfg, device="cpu"), want


def test_greedy_tokens_match_jax_engine(served):
    cfg, params, want = served
    for mode in MODES:
        eng = _engine(cfg, params, kv_dtype=mode)
        assert eng.k_pools.dtype == getattr(torch, mode)
        assert (eng.quant_scales is not None) == (mode == "int8")
        assert _serve(eng) == want[mode], mode


def test_byte_pools_halve_page_bytes():
    """A byte pool's page takes half a bf16 page's bytes, so the same
    budget holds twice the pages; byte pools need 32-token pages."""
    cfg = LlamaConfig.toy(dtype="float32")
    engines = {m: _engine(cfg, None, kv_dtype=m, num_pages=None, hbm_utilization=1e-3)
               for m in ("bfloat16",) + MODES}
    try:
        bf16 = engines["bfloat16"]
        for mode in MODES:
            e = engines[mode]
            assert e.kv_cfg.page_bytes * 2 == bf16.kv_cfg.page_bytes
            assert e.k_pools.element_size() == 1 and e.v_pools.dtype == e.k_pools.dtype
            assert e.pool.spec.num_pages // 2 == bf16.pool.spec.num_pages
            assert not e.k_pools[:, 0].view(torch.uint8).any(), "zero page"
    finally:
        for e in engines.values():
            e.shutdown()
    with pytest.raises(Exception, match="multiple of 32"):
        _engine(cfg, None, kv_dtype="int8", page_tokens=16)


def test_set_kv_scales_takes_effect(served):
    """Scales flow into the kernels: absurd ones change the tokens; any
    shape but [L, KH] raises."""
    cfg, params, _ = served
    eng = _engine(cfg, params, kv_dtype="int8")
    try:
        L, KH = cfg.num_layers, cfg.num_kv_heads
        assert eng.quant_scales[0].shape == (L, KH)
        before = [o.output_tokens for o in eng.generate(
            [[1, 2, 3]], SamplingParams(max_new_tokens=4))]
        eng.set_kv_scales(np.full((L, KH), 100.0), np.full((L, KH), 100.0))
        after = [o.output_tokens for o in eng.generate(
            [[1, 2, 3]], SamplingParams(max_new_tokens=4))]
        assert before != after
        for bad in (np.ones((L + 1, KH)), np.ones((L,)), np.ones((1, L, KH))):
            with pytest.raises(ValueError, match="set_kv_scales"):
                eng.set_kv_scales(bad, bad)
    finally:
        eng.shutdown()


def test_spec_decode_on_int8_pool_matches_plain(served):
    """float32 spec decode over an int8 pool keeps plain decode's tokens
    (both write the same quantized K/V), with drafts accepted on the
    repetitive prompt."""
    cfg, params, _ = served
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [7] * 5]
    plain = _serve(_engine(cfg, params, kv_dtype="int8"), prompts, 12)
    eng = _engine(cfg, params, kv_dtype="int8", spec_decode=True, spec_gamma=3)
    try:
        spec = [o.output_tokens for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=12))]
        m = eng.kv_metrics()["spec"]
    finally:
        eng.shutdown()
    assert spec == plain
    assert m["dispatches"] > 0 and m["tokens_per_iteration"] > 1
