"""head_dim 256 in the plain versions of K1, K1r, K2, K3 and K4 against the
JAX package's Pallas kernels run with ``interpret=True``, on the same numpy
inputs, and the head_dim contract of the kernel wrappers.

The plain versions are width-generic; this file holds them at Gemma2-9B's
head_dim 256 over float32 and int8 pools (per-head scales), soft-capped and
not: K1 (the fused write) int8 capped with a window, K1r float32 uncapped,
K2 int8 (a discarded page), K3 float32 uncapped with a window over a row
after a cached page and int8 capped within one page (over two pages the JAX
kernel rounds bf16 softmax weights against each page's running maximum, as
tests/test_torch_quant_ops.py notes), K4 int8 uncapped with a window (a row
overhanging its table, a discarded slot, a zero-length row).  The float32
capped modes of K1, K2, K3 and K4 run at this width in
tests/test_torch_hd256_model.py, inside the hybrid model's steps.  The
capped queries are scaled so that the scores reach several times the cap
(the uncapped outputs lie far outside the tolerance, asserted).  All JAX
calls compile as one program at XLA's lowest optimisation level, over one-
or two-page tables, the kernels copying one page a DMA chunk.

Tolerances: written pools are equal byte for byte; outputs agree within
atol 1e-5 (both sides compute in float32, in different summation orders;
the int8 cases round q and the softmax weights to bf16 operands at the same
places on both sides).

The CUDA kernels run only on the card: tests/test_torch_hd256_cuda.py
holds them against these plain versions there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.ops.paged_attention import paged_attention as j_readonly
from kvcached_tpu.ops.paged_attention import paged_attention_decode as j_decode
from kvcached_tpu.ops.paged_attention import paged_attention_verify as j_verify
from kvcached_tpu.ops.paged_attention import write_prefill_kv as j_write
from kvcached_tpu.ops.paged_prefill import paged_prefill_attention_batch as j_prefill
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest
from test_torch_quant_ops import _bytes, _t

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, KH, QH, TP, D = 2, 12, 2, 4, 32, 256
CAP = 5.0  # scores reach several times the cap: q scaled by 4
SM_SCALE = 256 ** -0.5  # Gemma-2-9B's query_pre_attn_scalar 256


def _pools(rng, int8):
    """K/V pools (page 0 zero; int8 codes at per-(layer, head) scales) and
    their scales."""
    scales = [(0.02 + 0.03 * rng.random((L, KH))).astype(np.float32) for _ in range(2)]
    pools = []
    for sc in scales:
        x = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
        if int8:
            x = np.clip(np.round(x / sc[:, None, :, None, None]), -127, 127).astype(np.int8)
        x[:, 0] = 0
        pools.append(x)
    return pools, scales


def _scales(int8, ks, vs, f):
    return dict(k_scales=f(ks), v_scales=f(vs)) if int8 else {}


def _cases(rng):
    """name -> (inputs, int8, keywords): one- or two-page tables."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    (kp, vp), (ks, vs) = _pools(rng, True)
    # K1: row 0 a full page cut by the window, row 1 a discarded write,
    # row 2 zero length, row 3 short
    seq = np.array([32, 27, 0, 9], np.int32)
    pt = np.array([[3], [2], [0], [7]], np.int32)
    pos = np.maximum(seq - 1, 0)
    sp = pt[np.arange(4), pos // TP].astype(np.int32)
    sp[1] = sp[2] = 0
    k1 = [4 * f32(4, QH, D), kp, vp, pt, seq, f32(4, KH, D), f32(4, KH, D), sp,
          (pos % TP).astype(np.int32), ks, vs]
    (kp, vp), _ = _pools(rng, False)
    k1r = [f32(3, QH, D), kp, vp, np.array([[5], [4], [0]], np.int32),
           np.array([TP, 9, 0], np.int32)]
    (kp, vp), (ks, vs) = _pools(rng, True)
    k2 = [kp, vp, f32(KH, 2 * TP, D), f32(KH, 2 * TP, D), np.array([6, 0], np.int32),
          ks[1], vs[1]]
    # K3: a row after cached tokens (q_start > 0), a fresh row, a kv_len = 0
    # row; float32 after a cached page, int8 within one page (over two, the
    # JAX kernel rounds its bf16 softmax weights against each page's
    # running maximum, the plain version against the row's)
    k3 = []
    for int8, scale, pt, q0 in ((False, 1, [[4, 9], [6, 0], [0, 0]], 32),
                                (True, 4, [[4], [6], [0]], 8)):
        (kp, vp), (ks, vs) = _pools(rng, int8)
        k3.append([scale * f32(3, 32, QH, D), kp, vp, np.array(pt, np.int32),
                   np.array([q0, 0, 0], np.int32), np.array([q0 + 20, 30, 0], np.int32), ks, vs])
    # K4: T = 3; a full page, a discarded slot, a row overhanging its table
    # by one token (that slot discarded), a zero-length row
    (kp, vp), (ks, vs) = _pools(rng, True)
    T = 3
    seq = np.array([TP, 21, TP + 1, 0], np.int32)
    pt = np.array([[3], [2], [6], [0]], np.int32)
    vpos = np.maximum(seq[:, None] - T + np.arange(T)[None], 0)
    inside = vpos < TP
    sp = np.where(inside, pt, 0).astype(np.int32)
    sp[1, 1] = 0
    sp[3] = 0
    k4 = [f32(4, T, QH, D), kp, vp, pt, seq, f32(4, T, KH, D), f32(4, T, KH, D), sp,
          (vpos % TP).astype(np.int32), ks, vs]
    live = (seq[:, None] - T + np.arange(T)[None] >= 0) & inside
    capped = dict(sm_scale=SM_SCALE, logit_softcap=CAP)
    return {"K1": (k1, True, dict(capped, window=20)),
            "K1r": (k1r, False, dict(sm_scale=SM_SCALE)),
            "K2": (k2, True, {}),
            "K3": (k3[0], False, dict(sm_scale=SM_SCALE, window=24)),
            "K3 int8": (k3[1], True, capped),
            "K4": (k4, True, dict(sm_scale=SM_SCALE, window=24))}, live


def test_hd256_plain_matches_jax():
    """Every kernel's plain version at head_dim 256 against the JAX kernel,
    in one JAX program; the capped outputs lie far from the uncapped."""
    rng = np.random.default_rng(0)
    cases, live = _cases(rng)

    def run(*arrays):
        it = iter(arrays)
        take = lambda n: [next(it) for _ in range(n)]  # noqa: E731
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = take(11)
        outs = [j_decode(q, kp, vp, pt, sl, 1, kn, vn, sp, so, interpret=True,
                         k_scales=ks, v_scales=vs, **cases["K1"][2])]
        outs.append(j_readonly(*take(5), 1, interpret=True, **cases["K1r"][2]))
        kp, vp, kn, vn, pages, ks, vs = take(7)
        outs.append(j_write(kp, vp, kn, vn, pages, 1, k_scale=ks, v_scale=vs,
                            interpret=True))
        for name in ("K3", "K3 int8"):
            q, kp, vp, pt, qs, kl, ks, vs = take(8)
            outs.append(j_prefill(q, kp, vp, pt, qs, kl, 1, interpret=True,
                                  **_scales(cases[name][1], ks, vs, lambda x: x),
                                  **cases[name][2]))
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = take(11)
        outs.append(j_verify(q, kp, vp, pt, sl, 1, kn, vn, sp, so, interpret=True,
                             k_scales=ks, v_scales=vs, **cases["K4"][2]))
        return outs

    got = jax_lowest(run, *[jnp.asarray(a) for c, _, _ in cases.values() for a in c])
    j = dict(zip(cases, got))

    # K1: the fused write and the capped, windowed attention over an int8 pool
    q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, cases["K1"][0])
    kw = cases["K1"][2]
    out, kp_t, vp_t = ops.paged_attention_decode(q, kp, vp, pt, sl, 1, kn, vn, sp, so,
                                                 k_scales=ks, v_scales=vs, **kw)
    out_j, kp_j, vp_j = j["K1"]
    np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j))
    np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    assert not out[2].any(), "a zero-length row gives zeros"
    uncapped = ops.paged_attention(q, kp_t, vp_t, pt, sl, 1, k_scales=ks, v_scales=vs,
                                   sm_scale=SM_SCALE, window=20)
    assert (uncapped - out).abs().max().item() > 1000 * ATOL

    # K1r: read-only, float32, uncapped
    args = list(map(_t, cases["K1r"][0]))
    out = ops.paged_attention(*args, 1, **cases["K1r"][2])
    np.testing.assert_allclose(out.numpy(), np.asarray(j["K1r"]), atol=ATOL, rtol=0)
    assert not out[2].any(), "a zero-length row gives zeros"

    # K2: the quantizing page writer, one chunk discarded
    kp, vp, kn, vn, pages, ks, vs = map(_t, cases["K2"][0])
    kp_t, vp_t = ops.write_prefill_kv(kp, vp, kn, vn, pages, 1, k_scale=ks, v_scale=vs)
    np.testing.assert_array_equal(_bytes(kp_t), _bytes(j["K2"][0]))
    np.testing.assert_array_equal(_bytes(vp_t), _bytes(j["K2"][1]))

    # K3: float32 uncapped with a window, int8 capped; padding query rows
    # are discarded
    for name in ("K3", "K3 int8"):
        arrays, int8, kw = cases[name]
        q, kp, vp, pt, qs, kl, ks, vs = map(_t, arrays)
        sc = _scales(int8, ks, vs, lambda x: x)
        out = ops.paged_prefill_attention_batch(q, kp, vp, pt, qs, kl, 1, **sc, **kw).numpy()
        out_j = np.asarray(j[name])
        for n in range(3):
            real = max(int(kl[n] - qs[n]), 0)
            np.testing.assert_allclose(out[n, :real], out_j[n, :real], atol=ATOL, rtol=0,
                                       err_msg=name)
        assert not out[2].any(), "a kv_len = 0 row gives zeros"
        if "logit_softcap" in kw:
            uncapped = ops.paged_prefill_attention_batch(q, kp, vp, pt, qs, kl, 1, **sc,
                                                         sm_scale=SM_SCALE).numpy()
            assert np.abs(uncapped - out)[:2].max() > 1000 * ATOL

    # K4: the fed tokens' writes and the windowed verify over an int8 pool
    q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, cases["K4"][0])
    out, kp_t, vp_t = ops.paged_attention_verify(q, kp, vp, pt, sl, 1, kn, vn, sp, so,
                                                 k_scales=ks, v_scales=vs, **cases["K4"][2])
    out_j, kp_j, vp_j = j["K4"]
    np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j))
    np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j))
    np.testing.assert_allclose(out.numpy()[live], np.asarray(out_j)[live], atol=ATOL, rtol=0)
    assert not out[3].any(), "a zero-length row gives zeros"


def test_hd256_wrapper_contract(monkeypatch):
    """head_dim 256 on CPU tensors runs the plain versions and counts no
    launch; a CUDA tensor (stubbed: no card here) at 256 asks for the
    head_dim 256 library of its kernel and raises when it cannot load it,
    never running the plain version; any width but 128 and 256 raises
    ValueError; a launch at 256 counts under ``"<type>[+softcap]+d256"``."""
    assert ops.paged_attention_decode.__module__.endswith("paged_attention")
    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")
    pp = importlib.import_module("kvcached_tpu_torch.ops.paged_prefill")
    build = importlib.import_module("kvcached_tpu_torch.ops._build")
    assert pa.KERNEL_HEAD_DIM == (128, 256)
    assert [build.lib_name(n, 256) for n in build.PER_HEAD_DIM] == [
        "paged_decode_d256", "paged_prefill_d256", "paged_verify_d256"]
    assert set(build.LIBRARIES) >= {"paged_decode", "paged_decode_d256", "prefill_write"}

    def inputs(d):
        rng = np.random.default_rng(1)
        g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        kp, vp = g(L, P, KH, TP, d), g(L, P, KH, TP, d)
        pt, sl = torch.tensor([[3], [2]], dtype=torch.int32), torch.tensor([9, 20],
                                                                           dtype=torch.int32)
        sp, so = torch.tensor([3, 2], dtype=torch.int32), torch.tensor([8, 19], dtype=torch.int32)
        dec = (g(2, QH, d), kp, vp, pt, sl, 0, g(2, KH, d), g(2, KH, d), sp, so)
        ver = (g(2, 1, QH, d), kp, vp, pt, sl, 0, g(2, 1, KH, d), g(2, 1, KH, d), sp[:, None],
               so[:, None])
        pre = (g(1, 32, QH, d), kp, vp, pt[:1], torch.tensor([0], dtype=torch.int32),
               torch.tensor([20], dtype=torch.int32), 0)
        wri = (kp, vp, g(KH, TP, d), g(KH, TP, d), torch.tensor([5], dtype=torch.int32), 0)
        return dec, ver, pre, wri

    dec, ver, pre, wri = inputs(D)
    counts = ops.launch_counts()
    out = ops.paged_attention_decode(*dec, logit_softcap=CAP)[0]
    want = ops.paged_attention_decode_plain(*dec, logit_softcap=CAP)[0]
    assert torch.equal(out, want)
    assert ops.paged_attention(*dec[:6]).shape == (2, QH, D)
    assert ops.paged_attention_verify(*ver)[0].shape == (2, 1, QH, D)
    assert ops.paged_prefill_attention_batch(*pre).shape == (1, 32, QH, D)
    ops.write_prefill_kv(*wri)
    assert ops.launch_counts() == counts, "the plain path counts no launch"

    asked = []

    def no_build(name):
        asked.append(name)
        raise RuntimeError("build refused")

    monkeypatch.setattr(build, "load", no_build)
    for mod in (pa, pp):
        monkeypatch.setattr(mod, "_on_cpu", lambda *ts: False)
    ran = []
    for mod, name in ((pa, "paged_attention_decode_plain"), (pa, "paged_attention_verify_plain"),
                      (pa, "write_prefill_kv_plain"), (pp, "paged_prefill_attention_batch_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: ran.append(a))
    calls = (lambda a: pa.paged_attention_decode(*a[0], logit_softcap=CAP),
             lambda a: pa.paged_attention(*a[0][:6]),
             lambda a: pa.paged_attention_verify(*a[1]),
             lambda a: pp.paged_prefill_attention_batch(*a[2]),
             lambda a: pa.write_prefill_kv(*a[3]))
    for call in calls:
        with pytest.raises(RuntimeError, match="build refused"):
            call((dec, ver, pre, wri))
    assert asked == ["paged_decode_d256", "paged_decode_d256", "paged_verify_d256",
                     "paged_prefill_d256", "prefill_write"]
    for d in (64, 192):
        other = inputs(d)
        for call in calls:
            with pytest.raises(ValueError, match="head_dim"):
                call(other)
    assert not ran, "the plain versions never ran"
    assert ops.launch_counts() == counts, "a launch that failed is not counted"

    seen = {}
    fn = type("W", (), {"launches": 0, "launches_by_dtype": seen})
    for cap, d in ((0.0, 128), (CAP, 128), (CAP, 256), (0.0, 256)):
        pa._count(fn, torch.bfloat16, cap, d)
    assert seen == {"bfloat16": 1, "bfloat16+softcap": 1, "bfloat16+softcap+d256": 1,
                    "bfloat16+d256": 1}
