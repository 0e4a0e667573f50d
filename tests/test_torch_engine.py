"""The port's engine against the JAX package's engine, and its sampling.

Parity: one JAX engine run (module-scoped, Pallas in interpret mode) and the
port's engine on the CPU serve the same requests with the same float32
parameters and float32 pools.  Greedy tokens must be identical across a
prefix-cache hit, a prompt longer than the largest prefill bucket (chunked
prefill), and a preemption under a small pool with batched prefill in the
port.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu.engine import EngineConfig as JEngineConfig
from kvcached_tpu.engine import LLMEngine as JLLMEngine
from kvcached_tpu.engine import SamplingParams as JSamplingParams
from kvcached_tpu.engine.engine import _filtered_scaled as j_filtered_scaled
from kvcached_tpu.models.llama import LlamaConfig as JLlamaConfig
from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.engine.engine import _filtered_scaled, _sample_tokens
from kvcached_tpu_torch.models.llama import LlamaConfig
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_fast_compile, jax_lowest, numpy_jax_params

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ENGINE = dict(max_batch=4, max_model_len=64, page_tokens=32, decode_horizon=4,
              prefill_buckets=(32,), num_pages=16, kv_dtype="float32",
              adaptive_horizon=False)
MAX_NEW = 8
#: three prompts that outgrow a small pool: the port preempts on them
PREEMPT_PROMPTS = [[5 + i] * 14 for i in range(3)]
PREEMPT_NEW = 24


def _workload():
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, 512, 32)]
    wave1 = [prefix + [1, 2, 3]]
    # wave 2: a prefix-cache hit, a 40-token prompt (two 32-token chunks)
    # and two short prompts
    wave2 = [prefix + [4, 5], [int(t) for t in rng.integers(0, 512, 40)],
             [7, 8, 9], [10, 11]]
    return wave1, wave2


@pytest.fixture(scope="module")
def served():
    """JAX engine's greedy tokens for both waves and for the preemption
    prompts, and the shared params."""
    jcfg = JLlamaConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_params(jcfg)
    eng = JLLMEngine(jcfg, JEngineConfig(interpret=True, **ENGINE), params=jparams)
    try:
        with jax_fast_compile():
            outs = [[o.output_tokens for o in eng.generate(
                w, JSamplingParams(max_new_tokens=MAX_NEW))] for w in _workload()]
            hits = eng.kv_metrics()["prefix_cache"]["hits"]
            preempt = [o.output_tokens for o in eng.generate(
                PREEMPT_PROMPTS, JSamplingParams(max_new_tokens=PREEMPT_NEW))]
    finally:
        eng.shutdown()
    cfg = LlamaConfig.toy(dtype="float32")
    return cfg, params_from_jax(tree, cfg, device="cpu"), outs, hits, preempt


def _engine(cfg, params, **kw):
    return LLMEngine(cfg, EngineConfig(**{**ENGINE, **kw}), params=params, device="cpu")


def _serve(eng, waves, sp=None):
    sp = sp or SamplingParams(max_new_tokens=MAX_NEW)
    try:
        return [[o.output_tokens for o in eng.generate(w, sp)] for w in waves]
    finally:
        eng.shutdown()


def test_greedy_tokens_match_jax_engine(served):
    cfg, params, want, jax_hits, _ = served
    eng = _engine(cfg, params)
    got = [[o.output_tokens for o in eng.generate(w, SamplingParams(max_new_tokens=MAX_NEW))]
           for w in _workload()]
    m = eng.kv_metrics()
    eng.shutdown()
    assert got == want
    assert m["prefix_cache"]["hits"] == jax_hits > 0, "the cache hit was taken"


def test_preemption_and_batched_prefill_keep_tokens(served):
    """A pool too small for three growing sequences forces preemption, and
    batched prefill stacks the waiting prompts; neither may change a token
    of the JAX engine's run."""
    cfg, params, _, _, want = served
    eng = _engine(cfg, params, num_pages=5, prefill_batch=4)
    got = [o.output_tokens for o in eng.generate(
        PREEMPT_PROMPTS, SamplingParams(max_new_tokens=PREEMPT_NEW))]
    m = eng.kv_metrics()
    eng.shutdown()
    assert got == want
    assert m["preemptions"] > 0
    assert m["prefill_batch"]["prompts_per_dispatch"] > 1


def test_filter_mask_matches_jax():
    """Sampled rows are held by their support: the same logits give the
    same top-k / top-p mask in both packages."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    logits[1, :8] = 3.0  # ties at the max
    temps = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_ks = np.array([5, 0, 12, 1], np.int32)
    top_ps = np.array([1.0, 0.8, 0.6, 0.9], np.float32)
    j = np.asarray(jax_lowest(lambda *a: j_filtered_scaled(*a, filters=True),
                              logits, temps, top_ks, top_ps))
    t = _filtered_scaled(*map(torch.from_numpy, (logits, temps, top_ks, top_ps)),
                         filters=True).numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)], rtol=1e-6)
    # draws stay inside the support
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        draw = _sample_tokens(*map(torch.from_numpy, (logits, temps, top_ks, top_ps)),
                              g, filters=True).numpy()
        assert np.isfinite(t[np.arange(4), draw]).all()


def test_seeded_sampling_reproducible(served):
    cfg, params, _, _, _ = served
    sp = SamplingParams(max_new_tokens=6, temperature=1.0, top_k=50, seed=7)
    runs = [_serve(_engine(cfg, params), [[[3, 1, 4, 1, 5], [9, 2, 6]]], sp)[0]
            for _ in range(2)]
    assert runs[0] == runs[1]
