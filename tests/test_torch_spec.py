"""The port's speculative-decoding engine against its plain engine and the
JAX package's spec engine.

Greedy rows accept a draft only when it equals the model's own argmax, so
at float32 the spec engine must give exactly the plain engine's tokens
(the port's counterpart of tests/test_spec_decode.py's TestSpecEngine).
One JAX spec engine run (module-scoped, Pallas in interpret mode) and the
port's engines on the CPU serve the same prompts with the same float32
parameters and pools.
"""

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

ECFG = dict(max_batch=3, max_model_len=64, page_tokens=32, decode_horizon=4,
            prefill_buckets=(32,), num_pages=16, kv_dtype="float32",
            adaptive_horizon=False, spec_gamma=2)
#: tests/test_spec_decode.py's prompts; the first is repetitive
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], list(range(40, 60)), [7] * 5]
NEW = 24


def _serve(cfg, params, sps, **kw):
    eng = LLMEngine(cfg, EngineConfig(**{**ECFG, **kw}), params=params, device="cpu")
    try:
        ids = [eng.add_request(list(p), sp) for p, sp in zip(PROMPTS, sps)]
        while eng.has_unfinished():
            eng.step()
        by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        return [by_id[i] for i in ids], eng.kv_metrics().get("spec")
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def served():
    """The JAX spec engine's greedy tokens, and the shared params."""
    jcfg = JLlamaConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_params(jcfg)
    eng = JLLMEngine(jcfg, JEngineConfig(interpret=True, spec_decode=True, **ECFG),
                     params=jparams)
    try:
        with jax_fast_compile():
            want = [o.output_tokens for o in eng.generate(
                PROMPTS, JSamplingParams(max_new_tokens=NEW))]
        assert eng.kv_metrics()["spec"]["dispatches"] > 0
    finally:
        eng.shutdown()
    cfg = LlamaConfig.toy(dtype="float32")
    return cfg, params_from_jax(tree, cfg, device="cpu"), want


def test_spec_tokens_match_plain_and_jax(served):
    cfg, params, jax_spec = served
    sps = [SamplingParams(max_new_tokens=NEW)] * 3
    plain, _ = _serve(cfg, params, sps)
    spec, m = _serve(cfg, params, sps, spec_decode=True)
    assert spec == plain == jax_spec
    assert m["dispatches"] > 0
    # the repetitive prompt drafts well: more than one token per dispatch
    assert m["tokens_per_dispatch"] > 1 and m["tokens_per_iteration"] > 1


def test_staggered_caps_keep_tokens(served):
    """Rows finishing at different caps leave the batch mid-horizon; the
    rest stay token-exact (overflow writes routed to the zero page)."""
    cfg, params, _ = served
    sps = [SamplingParams(max_new_tokens=n) for n in (2, 7, 23)]
    want, _ = _serve(cfg, params, sps)
    got, _ = _serve(cfg, params, sps, spec_decode=True)
    assert got == want


def test_mixed_batch_greedy_rows_unchanged(served):
    """A sampled row rides the spec path by rejection sampling; the greedy
    rows beside it keep the plain engine's tokens."""
    cfg, params, _ = served
    want, _ = _serve(cfg, params, [SamplingParams(max_new_tokens=12)] * 3)
    mixed = [SamplingParams(max_new_tokens=12),
             SamplingParams(max_new_tokens=12, temperature=0.8, top_k=20, seed=3),
             SamplingParams(max_new_tokens=12)]
    got, m = _serve(cfg, params, mixed, spec_decode=True)
    assert m["dispatches"] > 0
    assert got[0] == want[0] and got[2] == want[2]
    assert len(got[1]) == 12 and all(0 <= t < cfg.vocab_size for t in got[1])


def test_spec_exact_refuses_sub_float32():
    """bf16 params, or float32 params over bf16 KV, cannot promise
    token-exactness: spec_exact refuses both."""
    for model_dtype in ("bfloat16", "float32"):
        cfg = LlamaConfig.toy(dtype=model_dtype)
        with pytest.raises(ValueError, match="spec_exact.*kv_dtype"):
            LLMEngine(cfg, EngineConfig(**{**ECFG, "kv_dtype": "bfloat16"},
                                        spec_decode=True, spec_exact=True),
                      device="cpu")
