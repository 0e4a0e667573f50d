"""The MLA family over byte latent pools (int8 with one scale a layer, and
float8_e4m3fn): the port's model steps against the JAX package's, the
port's engine against the reference's own int8 MLA criterion, and the byte
latent pool's page size.

``MLAConfig.toy`` at float32.  The model-step test runs a batched prefill,
two decode steps and a verify step on each byte pool in both packages (JAX
with its Pallas kernels in interpret mode, each step compiled once as one
program at XLA's lowest optimisation level for both pool types).  The
engine-level comparison with the JAX package's int8 MLA engine is in
tests/test_torch_mla_engine.py.

Tolerances.  Pools, compared as bytes: both sides quantize with the
reference's rounding (tests/test_torch_mla_quant_ops.py holds the writes
bit-equal on identical inputs), but the latent entries they quantize are
the float32 projections' outputs, summed in different orders by XLA and
PyTorch (within 1e-5, tests/test_torch_mla_model.py).  An entry within
that distance of a rounding boundary quantizes to neighbouring codes on
the two sides: 2-7 of ~24,500 written values a step here.  So every code
is equal except at most 0.1% of the written values, and those are
neighbours.  Logits within 5e-3 (measured: 2.5e-3 at most): both sides
round q and the softmax weights to bf16 operands, where float32 noise can
likewise round an element to neighbouring bf16 values (0.4% apart), and
a neighbouring code moves an entry by one quantization step; float32
pools hold 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.models import mla as jm
from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models import mla as tm
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_compile_lowest
from test_torch_mla_model import numpy_jax_mla_params
from test_torch_quant_ops import MODES, NP_DTYPE, _bytes

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

P, TP = 8, 32
LOGITS_ATOL = 5e-3
#: the written latent values that may sit on the other side of a
#: quantization boundary in the two packages (measured: at most 7 of
#: ~24,500 per step, 2.9e-4)
BOUNDARY_SHARE = 1e-3


def _same_pools_but_boundaries(mode, tk, jk, what, share=BOUNDARY_SHARE, written=None):
    """The two packages' byte pools hold the same codes, except where the
    latent entries' float32 rounding put a value on the other side of a
    quantization boundary: there the codes are neighbours (one int8 step,
    or adjacent e4m3 magnitudes of one sign), at no more than ``share`` of
    the ``written`` values (by default the pool's nonzero codes: it started
    at zero)."""
    a, b = _bytes(tk), _bytes(jk)
    bad = a != b
    if written is None:
        written = int((a != 0).sum())
    assert written > 0 and bad.sum() <= share * written, (what, int(bad.sum()), written)
    if mode == "int8":
        step = np.abs(a[bad].view(np.int8).astype(int) - b[bad].view(np.int8).astype(int))
        assert (step == 1).all(), (what, a[bad].view(np.int8), b[bad].view(np.int8))
    else:
        same_sign = ((a[bad] ^ b[bad]) & 0x80) == 0
        step = np.abs((a[bad] & 0x7F).astype(int) - (b[bad] & 0x7F).astype(int))
        assert same_sign.all() and (step == 1).all(), (what, a[bad], b[bad])


def test_model_steps_match_jax_on_byte_pools():
    """A batched prefill of two rows of different lengths, then two decode
    steps (the first with one write discarded) and a verify step of T=2
    fed tokens (one write discarded), continuing from the same pools, on an
    int8 pool (per-layer scales) and on an e4m3 pool."""
    jcfg = jm.MLAConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_mla_params(jcfg)
    tcfg = tm.MLAConfig.toy(dtype="float32")
    tparams = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    V = jcfg.vocab_size
    ks = np.array([[0.04], [0.03]], np.float32)  # [L, 1]
    N, T, Tv = 2, 32, 2
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    tokens = i32(rng.integers(0, V, (N, T)))
    q_starts, true_lens = i32([0, 0]), i32([20, 25])
    positions = i32(np.arange(T)[None].repeat(N, 0))
    page_tables = i32([[3], [5]])
    pos = q_starts + true_lens
    decodes = []
    for k in range(2):  # two decode steps; the first discards row 1's write
        sp = page_tables[:, 0].copy()
        if k == 0:
            sp[1] = 0
        decodes.append((i32(rng.integers(0, V, N)), i32(pos + k), page_tables, i32(sp),
                        i32((pos + k) % TP), i32(pos + k + 1)))
    vpos = i32(pos[:, None] + 2 + np.arange(Tv)[None])
    vsp = i32(np.repeat(page_tables, Tv, 1))
    vsp[0, 1] = 0
    verify = (i32(rng.integers(0, V, (N, Tv))), vpos, page_tables, vsp, i32(vpos % TP),
              i32(pos + 2 + Tv))

    def both(step):
        """JAX: ``step`` on the int8 pool (with scales) and the e4m3 pool."""
        def run(p, sc, kp8, kpf, *a):
            return [step(p, jcfg, *a[:2], kp, None, *a[2:], interpret=True,
                         **({"quant_scales": (sc, sc)} if kp is kp8 else {}))[:2]
                    for kp in (kp8, kpf)]
        return run

    jpools = [jnp.zeros((jcfg.num_layers, P, 1, TP, jcfg.cache_head_dim), NP_DTYPE[m])
              for m in MODES]
    tpools = [torch.zeros(tuple(jpools[0].shape), dtype=getattr(torch, m)) for m in MODES]
    tsc = torch.from_numpy(ks)
    sc_kw = [dict(quant_scales=(tsc, tsc)), {}]
    jsc = jnp.asarray(ks)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731

    def check(what, jouts, touts):
        for mode, (jl, jk), (tl_, tk) in zip(MODES, jouts, touts):
            _same_pools_but_boundaries(mode, tk, jk, f"{what} {mode}")
            np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0,
                                       err_msg=f"{what} {mode}")

    prefill_args = (tokens, positions, page_tables, page_tables, q_starts, true_lens)
    jargs = [jnp.asarray(a) for a in prefill_args]
    jouts = jax_compile_lowest(both(jm.mla_prefill_batch_step), jparams, jsc, *jpools,
                               *jargs)(jparams, jsc, *jpools, *jargs)
    touts = [tm.mla_prefill_batch_step(tparams, tcfg, *map(t, prefill_args[:2]), kp, None,
                                       *map(t, prefill_args[2:]), **kw)[:2]
             for kp, kw in zip(tpools, sc_kw)]
    check("prefill", jouts, touts)
    jpools = [jk for _, jk in jouts]

    decode = None
    for k, args in enumerate(decodes):
        jargs = [jnp.asarray(a) for a in args]
        if decode is None:
            decode = jax_compile_lowest(both(jm.mla_decode_step), jparams, jsc, *jpools, *jargs)
        jouts = decode(jparams, jsc, *jpools, *jargs)
        touts = [tm.mla_decode_step(tparams, tcfg, *map(t, args[:2]), kp, None,
                                    *map(t, args[2:]), **kw)[:2]
                 for kp, kw in zip(tpools, sc_kw)]
        check(f"decode {k}", jouts, touts)
        jpools = [jk for _, jk in jouts]

    jargs = [jnp.asarray(a) for a in verify]
    jouts = jax_compile_lowest(both(jm.mla_verify_step), jparams, jsc, *jpools,
                               *jargs)(jparams, jsc, *jpools, *jargs)
    touts = [tm.mla_verify_step(tparams, tcfg, *map(t, verify[:2]), kp, None,
                                *map(t, verify[2:]), **kw)[:2]
             for kp, kw in zip(tpools, sc_kw)]
    assert touts[0][0].shape == (N, Tv, tcfg.vocab_size)
    check("verify", jouts, touts)


ECFG = dict(max_batch=2, max_model_len=128, page_tokens=32, decode_horizon=4,
            prefill_buckets=(32, 64), num_pages=32, kv_dtype="int8", kv_scale=0.02)


def _run(cfg, params, prompts, sp, **over):
    eng = LLMEngine(cfg, EngineConfig(**{**ECFG, **over}), params=params, device="cpu")
    try:
        return [o.output_tokens for o in eng.generate(prompts, sp)]
    finally:
        eng.shutdown()


def test_int8_latent_engine_deterministic_first_tokens_and_spec():
    """The reference's int8 MLA engine criterion (tests/test_int8_kv.py,
    ``test_int8_mla_engine``) on the port's engine: generation is
    deterministic, the first tokens agree with a float32 pool's, and spec
    decode keeps int8 plain decode's tokens."""
    cfg = tm.MLAConfig.toy(dtype="float32")
    params = tm.init_mla_params(cfg, seed=0, device="cpu")
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [9] * 5]
    sp = SamplingParams(max_new_tokens=10)
    a = _run(cfg, params, prompts, sp)
    assert a == _run(cfg, params, prompts, sp), "int8 MLA generation not deterministic"
    ref = _run(cfg, params, prompts, sp, kv_dtype="float32")
    assert [x[0] for x in a] == [x[0] for x in ref], "first tokens diverged"
    assert _run(cfg, params, prompts, sp, spec_decode=True, spec_gamma=3) == a, (
        "int8 MLA spec decode diverged from int8 plain decode")


def test_byte_latent_pages_are_half_of_bf16():
    """A byte latent page takes half a bf16 page's bytes, so one budget
    holds twice the pages; an int8 latent pool has one scale a layer, [L,
    1] (set_kv_scales refuses other shapes); both byte pools serve."""
    cfg = tm.MLAConfig.toy(dtype="float32")
    params = tm.init_mla_params(cfg, seed=1, device="cpu")
    mk = lambda m: LLMEngine(cfg, EngineConfig(  # noqa: E731
        **{**ECFG, "kv_dtype": m, "num_pages": None, "hbm_utilization": 1e-3}),
        params=params, device="cpu")
    engines = {m: mk(m) for m in ("bfloat16",) + MODES}
    try:
        bf16 = engines["bfloat16"]
        L = cfg.num_layers
        for mode in MODES:
            e = engines[mode]
            assert e.v_pools is None and e.k_pools.dtype == getattr(torch, mode)
            assert e.kv_cfg.page_bytes * 2 == bf16.kv_cfg.page_bytes
            assert e.kv_cfg.page_bytes == L * TP * cfg.cache_head_dim  # one buffer, 1 B a lane
            assert e.pool.spec.num_pages // 2 == bf16.pool.spec.num_pages
            assert not e.k_pools[:, 0].view(torch.uint8).any(), "zero page"
            out = e.generate([[5, 6, 7]], SamplingParams(max_new_tokens=3))[0].output_tokens
            assert len(out) == 3 and all(0 <= x < cfg.vocab_size for x in out)
        i8 = engines["int8"]
        assert [tuple(s.shape) for s in i8.quant_scales] == [(L, 1), (L, 1)]
        assert engines["float8_e4m3fn"].quant_scales is None
        i8.set_kv_scales(np.full((L, 1), 0.03), np.full((L, 1), 0.03))
        with pytest.raises(ValueError, match="set_kv_scales"):
            i8.set_kv_scales(np.ones((L, 2)), np.ones((L, 2)))
    finally:
        for e in engines.values():
            e.shutdown()
