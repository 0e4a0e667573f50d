"""The port's engine on the hybrid family (two layer groups over one shared
arena) against the JAX package's engine, and its per-group page lifetimes
and limits.

Parity: one JAX engine run (module-scoped, Pallas in interpret mode, serial
prefill) and the port's engine on the CPU (batched prefill) serve the same
requests with the same float32 parameters and float32 pools: greedy tokens
must be identical across a batched prefill of three prompts and a prompt
longer than the largest prefill bucket (chunked prefill), whose decode
steps the sliding group's window cuts; with speculative decoding too (the
hybrid verify step, every group drafting).  The toy carries the Gemma2
knobs with mild caps (a final cap far below the logits' spread would make
near-ties, and greedy parity would then hang on float32 summation order).

Port only: the sliding group frees the pages that slid out of its window
while the full group keeps every page, and its pages return to the shared
arena; each group has its shm segment, and a limit written on group 1's
(``_g1``) resizes that group alone, with outputs md5-identical to an
unconstrained run; on int8 and e4m3 arenas the reference's own criterion
(``tests/test_int8_kv.py``'s ``test_equal_groups_deterministic_spec_and_
batched``); unequal groups and per-group arenas raise.  The file holds four
tests: the port's files run last in Tier-1 (loadfile queues files by their
count of collected items), and the new ones should not push older ones
out.
"""

import hashlib
import time
import uuid

import numpy as np
import pytest
import torch

from kvcached_tpu.engine import EngineConfig as JEngineConfig
from kvcached_tpu.engine import LLMEngine as JLLMEngine
from kvcached_tpu.engine import SamplingParams as JSamplingParams
from kvcached_tpu.models.hybrid import HybridConfig as JHybridConfig
from kvcached_tpu_torch import shm
from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.adapter import HybridAdapter
from kvcached_tpu_torch.models.hybrid import HybridConfig, hybrid_verify_step, init_hybrid_params
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_hybrid_model import numpy_hybrid_params
from test_torch_llama import jax_fast_compile

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

TOY = dict(dtype="float32", act="gelu_tanh", norm_offset=True, embed_scale=True,
           post_norms=True, query_scale=64.0, attn_softcap=5.0, final_softcap=8.0)
ENGINE = dict(max_batch=4, max_model_len=64, page_tokens=32, decode_horizon=4,
              prefill_buckets=(32,), num_pages=24, kv_dtype="float32",
              adaptive_horizon=False)
MAX_NEW = 8


def _workload():
    """Three short prompts first (the port batches their prefill), then a
    40-token prompt (two 32-token chunks; its decode passes the toy's
    32-token window)."""
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 512, n)] for n in (5, 12, 30, 40)]


@pytest.fixture(scope="module")
def served():
    jcfg = JHybridConfig.toy(**TOY)
    jparams, tree = numpy_hybrid_params(jcfg)
    eng = JLLMEngine(jcfg, JEngineConfig(interpret=True, **ENGINE), params=jparams)
    try:
        with jax_fast_compile():
            want = [o.output_tokens for o in eng.generate(
                _workload(), JSamplingParams(max_new_tokens=MAX_NEW))]
    finally:
        eng.shutdown()
    cfg = HybridConfig.toy(**TOY)
    return cfg, params_from_jax(tree, cfg, device="cpu"), want


def _engine(cfg, params, **kw):
    return LLMEngine(cfg, EngineConfig(**{**ENGINE, **kw}), params=params, device="cpu")


def test_greedy_tokens_match_jax_engine(served):
    cfg, params, want = served
    eng = _engine(cfg, params, prefill_batch=4)
    try:
        got = [o.output_tokens for o in eng.generate(
            _workload(), SamplingParams(max_new_tokens=MAX_NEW))]
        m = eng.kv_metrics()
    finally:
        eng.shutdown()
    assert got == want
    assert m["prefill_batch"]["prompts_per_dispatch"] == 3, "the short prompts were batched"
    assert [g["window"] for g in m["groups"]] == [None, 32]
    assert m["prefix_cache"]["hits"] == 0, "the prefix cache is off for layer groups"
    # unequal groups (per-group arenas) on the hybrid family are a later
    # slice: they raise, in the adapter and in the model steps
    with pytest.raises(NotImplementedError, match="A11b"):
        HybridAdapter(HybridConfig.toy(num_layers=3))  # groups of 2 and 1 layers
    with pytest.raises(NotImplementedError, match="A11b"):
        hybrid_verify_step(params, cfg, None, None, (None, None), (None, None),
                           None, None, None, None)


def test_spec_tokens_match_jax_engine(served):
    """Speculative decoding on the hybrid family (spec_exact at float32):
    the JAX engine's plain-decode tokens, through verify dispatches."""
    cfg, params, want = served
    eng = _engine(cfg, params, prefill_batch=4, spec_decode=True, spec_exact=True)
    try:
        got = [o.output_tokens for o in eng.generate(
            _workload(), SamplingParams(max_new_tokens=MAX_NEW))]
        spec = eng.kv_metrics()["spec"]
    finally:
        eng.shutdown()
    assert got == want
    assert spec["dispatches"] > 0 and spec["iterations"] > 0, spec


def test_byte_arenas_reference_criterion():
    """The reference's criterion for int8 layer groups
    (``tests/test_int8_kv.py``, ``TestInt8HybridGroups``), on the port for
    int8 and e4m3 arenas: output deterministic, first tokens equal float32's,
    spec decode equal to plain decode, batched prefill equal to plain; int8
    scales come per model layer, and the arena's shape is refused."""
    cfg = HybridConfig.toy(num_layers=4, window=32, dtype="float32")
    params = init_hybrid_params(cfg, seed=0, device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9] * 5]
    base = dict(max_batch=3, max_model_len=128, page_tokens=32, decode_horizon=4,
                prefill_buckets=(32, 64), num_pages=32, kv_scale=0.05,
                enable_prefix_caching=False)

    def run(**kw):
        eng = LLMEngine(cfg, EngineConfig(**{**base, **kw}), params=params, device="cpu")
        try:
            return [o.output_tokens for o in eng.generate(
                prompts, SamplingParams(max_new_tokens=8))]
        finally:
            eng.shutdown()

    ref = run(kv_dtype="float32")
    for kv in ("int8", "float8_e4m3fn"):
        a = run(kv_dtype=kv)
        assert a == run(kv_dtype=kv), f"{kv}: not deterministic"
        assert [t[0] for t in a] == [t[0] for t in ref], f"{kv}: first tokens diverged"
        assert run(kv_dtype=kv, spec_decode=True, spec_gamma=2, spec_horizon=2) == a, kv
        assert run(kv_dtype=kv, prefill_batch=2) == a, f"{kv}: batched prefill diverged"

    eng = LLMEngine(cfg, EngineConfig(**base, kv_dtype="int8"), params=params, device="cpu")
    try:
        L, KH = cfg.num_layers, cfg.num_kv_heads
        assert tuple(eng.quant_scales[0].shape) == (L, KH), "per model layer"
        scales = np.linspace(0.04, 0.06, L * KH, dtype=np.float32).reshape(L, KH)
        eng.set_kv_scales(scales, scales)
        assert torch.equal(eng.quant_scales[1], torch.from_numpy(scales))
        with pytest.raises(ValueError, match="model layers"):
            eng.set_kv_scales(scales[:eng.kv_cfg.num_layers], scales[:eng.kv_cfg.num_layers])
    finally:
        eng.shutdown()


def test_group_lifetimes_arena_and_g1_limit(served):
    """Per-group page lifetimes over one arena, and a live limit on group
    1's segment."""
    cfg, params, _ = served
    _sliding_group_frees_pages_full_group_keeps(cfg, params)
    _g1_limit_resizes_group_1_only(cfg, params)


def _sliding_group_frees_pages_full_group_keeps(cfg, params):
    """Window 32, 16-token pages, 116 tokens: the sliding group's live pages
    stay bounded while the full group keeps all of its own; what the sliding
    group frees goes back to the one arena, which the other group can take."""
    eng = _engine(cfg, params, max_model_len=160, page_tokens=16, prefill_buckets=(16,),
                  num_pages=32)
    try:
        eng.add_request([7] * 16, SamplingParams(max_new_tokens=100))
        peak_full = peak_sw = 0
        end = None
        while eng.has_unfinished():
            eng.step()
            if eng.running:
                seq = eng.running[0]
                n_full, n_sw = (sum(b is not None for b in row) for row in seq.blocks_g)
                peak_full, peak_sw = max(peak_full, n_full), max(peak_sw, n_sw)
                end = (n_full, n_sw, len(seq.blocks_g[1]))
        assert peak_sw <= 4, f"the sliding group never reclaimed: {peak_sw} pages"
        assert peak_full >= 7 and end[0] == end[2] > end[1], end
        # one arena: pages group 1 gives back, group 0 can take
        total = eng.pool.capacity - 1  # the zero page
        a = eng.managers[0].alloc(total // 2)
        b = eng.managers[1].alloc(total - total // 2 - 2)
        assert a is not None and b is not None
        assert eng.managers[0].alloc(4) is None, "the arena is shared and full"
        eng.managers[1].free(b)
        eng.managers[1].trim()
        c = eng.managers[0].alloc(4)
        assert c is not None
        eng.managers[0].free(a + c)
    finally:
        eng.shutdown()


def _g1_limit_resizes_group_1_only(cfg, params):
    """Each group has its shm segment (``<name>_g1`` for group 1); a limit
    written on ``_g1`` resizes group 1's manager alone mid-run (SHRANK,
    then GREW), and the outputs stay md5-identical to an unconstrained run
    (CORRECT).  The limit is written in this process, as the reference's
    ``test_per_group_elastic_and_remote_limit`` does: the engine sees it
    only through the shm segment and its resize watcher, and
    ``test_torch_elastic.py`` holds a write from another process."""
    kw = dict(max_model_len=96, page_tokens=16, prefill_buckets=(32,), num_pages=48)
    prompts = [[i + 1, i + 2, i + 3, i + 4] * (2 + i % 3) for i in range(6)]
    sp = SamplingParams(max_new_tokens=24)
    free = _engine(cfg, params, **kw)
    try:
        want = [o.output_tokens for o in free.generate(prompts, sp)]
    finally:
        free.shutdown()
    name = f"kvcached_torch_hyb_{uuid.uuid4().hex[:8]}"
    eng = _engine(cfg, params, ipc_name=name, **kw)
    g0, g1 = eng.managers

    def set_limit(nbytes):
        shm.update_kv_cache_limit(f"{name}_g1", nbytes)
        deadline = time.time() + 10
        while g1.page_allocator.limit_pages != nbytes // eng.kv_cfg.page_bytes:
            assert time.time() < deadline, "the limit was never taken up"
            time.sleep(0.02)
            g1.alloc(0)

    try:
        assert shm.get_kv_cache_info(name) is not None
        assert shm.get_kv_cache_info(f"{name}_g1") is not None
        full = g1.page_allocator.limit_pages
        ids = [eng.add_request(p, sp) for p in prompts]
        while len(eng.running) < 4 and eng.has_unfinished():
            eng.step()
        small = max(g1.page_allocator.num_in_use // 2, 3)
        set_limit(small * eng.kv_cfg.page_bytes)
        assert g0.page_allocator.limit_pages == full, "group 0 keeps its limit"
        assert shm.get_kv_cache_info(name).total_size != small * eng.kv_cfg.page_bytes
        for _ in range(3):  # serve under the cut: group 1's growth preempts
            eng.step()
        assert eng.has_unfinished() and eng.kv_metrics()["preemptions"] > 0, "SHRANK"
        set_limit(full * eng.kv_cfg.page_bytes)
        assert g1.available_size() > 0, "GREW"
        while eng.has_unfinished():
            eng.step()
        by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        got = [by_id[i] for i in ids]
    finally:
        eng.shutdown()
    md5 = lambda x: hashlib.md5(str(x).encode()).hexdigest()  # noqa: E731
    assert md5(got) == md5(want), "CORRECT"
