"""The port's MLA engine against the JAX package's MLA engine, and its
elastic limit.

Two JAX engine runs (module-scoped, Pallas in interpret mode), one on a
float32 latent pool and one on an int8 latent pool (the engine's default
scale), and the port's engines on the CPU serve the same prompts with the
same float32 parameters.  Greedy rows accept a draft only when it equals
the model's own argmax, so at float32 the port's speculative engine must
give exactly the plain engine's tokens, and both the JAX engine's; on the
int8 pool the port's greedy tokens must be the JAX engine's.
"""

import hashlib
import time
import uuid

import pytest
import torch

from kvcached_tpu.engine import EngineConfig as JEngineConfig
from kvcached_tpu.engine import LLMEngine as JLLMEngine
from kvcached_tpu.engine import SamplingParams as JSamplingParams
from kvcached_tpu.models.mla import MLAConfig as JMLAConfig
from kvcached_tpu_torch import shm
from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.mla import MLAConfig
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_fast_compile
from test_torch_mla_model import numpy_jax_mla_params

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

#: 32-token pages and 2-page tables: the JAX kernels' interpret-mode
#: compile grows with the table width
ECFG = dict(max_batch=3, max_model_len=64, page_tokens=32, decode_horizon=4,
            prefill_buckets=(32,), num_pages=64, kv_dtype="float32",
            adaptive_horizon=False)
#: the first prompt is repetitive (it drafts well); the second outgrows the
#: bucket (chunked prefill)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], list(range(40, 80)), [7] * 5]
NEW = 10


@pytest.fixture(scope="module")
def served():
    """The JAX MLA engine's greedy tokens on the float32 latent pool, the
    shared params, and its greedy tokens on the int8 latent pool."""
    jcfg = JMLAConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_mla_params(jcfg)
    want = {}
    for kv_dtype in ("float32", "int8"):
        eng = JLLMEngine(jcfg, JEngineConfig(interpret=True, **{**ECFG, "kv_dtype": kv_dtype}),
                         params=jparams)
        try:
            with jax_fast_compile():
                want[kv_dtype] = [o.output_tokens for o in eng.generate(
                    PROMPTS, JSamplingParams(max_new_tokens=NEW))]
        finally:
            eng.shutdown()
    cfg = MLAConfig.toy(dtype="float32")
    return cfg, params_from_jax(tree, cfg, device="cpu"), want


def _engine(cfg, params, **kw):
    return LLMEngine(cfg, EngineConfig(**{**ECFG, **kw}), params=params, device="cpu")


def _serve(eng, prompts, sp):
    try:
        return [o.output_tokens for o in eng.generate(prompts, sp)], eng.kv_metrics()
    finally:
        eng.shutdown()


def test_tokens_match_jax_with_spec_off_and_on(served):
    cfg, params, by_pool = served
    want = by_pool["float32"]
    sp = SamplingParams(max_new_tokens=NEW)
    eng = _engine(cfg, params)
    assert eng.v_pools is None and eng.kv_cfg.num_kv_buffers == 1
    assert tuple(eng.k_pools.shape[2:]) == (1, 32, cfg.cache_head_dim)
    plain, _ = _serve(eng, PROMPTS, sp)
    spec, m = _serve(_engine(cfg, params, spec_decode=True, spec_exact=True), PROMPTS, sp)
    assert plain == want
    assert spec == want
    assert m["spec"]["dispatches"] > 0 and m["spec"]["tokens_per_iteration"] > 1


def test_prefix_hit_batched_prefill_and_sampled_row(served):
    """A prefix-cache hit and batched prefill keep the greedy tokens; a
    seeded sampled row beside them is reproducible."""
    cfg, params, by_pool = served
    want = by_pool["float32"]
    sp = SamplingParams(max_new_tokens=NEW)
    eng = _engine(cfg, params, prefill_batch=4)
    first = eng.generate([PROMPTS[1]], sp)[0].output_tokens
    # the two short prompts stack into one prefill; the long one hits the cache
    got, m = _serve(eng, [PROMPTS[0], PROMPTS[2], PROMPTS[1]], sp)
    assert got == [want[0], want[2], want[1]] and first == want[1]
    assert m["prefix_cache"]["hits"] > 0
    assert m["prefill_batch"]["prompts_per_dispatch"] > 1
    sampled = SamplingParams(max_new_tokens=6, temperature=0.9, top_k=20, seed=5)
    runs = [_serve(_engine(cfg, params), [PROMPTS[0], PROMPTS[2]], sampled)[0]
            for _ in range(2)]
    assert runs[0] == runs[1] and all(0 <= t < cfg.vocab_size for r in runs[0] for t in r)


def test_live_limit_shrinks_and_grows_the_latent_pool(served):
    """A limit written through the shm plane (what ``kvctl limit`` does)
    sizes pages of the single pool (num_kv_buffers = 1): the pool shrinks
    under load, grows back, and the outputs stay md5-identical."""
    cfg, params, _ = served
    sp = SamplingParams(max_new_tokens=24)
    prompts = [[i + 1, i + 2, i + 3, i + 4] * 3 for i in range(3)]
    free, _ = _serve(_engine(cfg, params), prompts, sp)
    name = f"kvcached_torch_mla_{uuid.uuid4().hex[:8]}"
    eng = _engine(cfg, params, ipc_name=name, enable_prefix_caching=False)
    page_bytes = eng.kv_cfg.page_bytes
    assert page_bytes == cfg.num_layers * 32 * cfg.cache_head_dim * 4  # one buffer
    alloc = eng.managers[0].page_allocator

    def set_limit(pages):
        shm.update_kv_cache_limit(eng.ipc_name, pages * page_bytes)
        deadline = time.time() + 10
        while alloc.limit_pages != pages:
            assert time.time() < deadline, f"limit {pages} never taken up"
            time.sleep(0.02)
            eng.managers[0].alloc(0)

    try:
        ids = [eng.add_request(p, sp) for p in prompts]
        eng.step()
        full = alloc.limit_pages
        set_limit(4)
        for _ in range(3):
            eng.step()
        set_limit(full)
        while eng.has_unfinished():
            eng.step()
        by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        got = [by_id[i] for i in ids]
    finally:
        eng.shutdown()
    md5 = lambda x: hashlib.md5(str(x).encode()).hexdigest()  # noqa: E731
    assert md5(got) == md5(free)


def test_int8_latent_pool_tokens_match_jax(served):
    """On an int8 latent pool (one scale a layer, the engine's default) the
    port's engine gives the JAX engine's greedy tokens, across the chunked
    prompt and a page crossing."""
    cfg, params, by_pool = served
    eng = _engine(cfg, params, kv_dtype="int8")
    assert eng.k_pools.dtype == torch.int8 and eng.v_pools is None
    assert tuple(eng.quant_scales[0].shape) == (cfg.num_layers, 1)
    got, _ = _serve(eng, PROMPTS, SamplingParams(max_new_tokens=NEW))
    assert got == by_pool["int8"]
