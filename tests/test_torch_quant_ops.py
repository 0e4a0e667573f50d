"""Plain versions of the port's kernels over byte pools (int8 with per-head
scales, and float8_e4m3fn) against the JAX package's Pallas kernels run
with ``interpret=True``, on the same numpy inputs: K1 with K1r, K2, K3 and
K4, each test covering both byte types.

The attention kernels' page tables hold one 32-token page (byte pools need
a 32-token granule): interpret mode lowers one DMA body for each page a
chunk holds, ~1.5 s a kernel at two pages.  Each test compiles its JAX
calls as one program at XLA's lowest optimisation level.

Tolerances: written pools are bit-equal, compared as bytes (an e4m3 NaN
never equals itself); outputs agree within atol 1e-5 at float32 inputs,
since both sides round q and the softmax weights to bf16 operands at the
same places and differ only in summation order.

The CUDA kernels themselves run only on the card:
tests/test_torch_quant_cuda.py holds them against these plain versions.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from kvcached_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_decode as j_decode,
    paged_attention_verify as j_verify,
    write_prefill_kv as j_write_prefill_kv,
)
from kvcached_tpu.ops.paged_prefill import (
    paged_prefill_attention_batch as j_prefill_batch,
)
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, KH, QH, TP, D = 2, 8, 2, 4, 32, 128
MODES = ("int8", "float8_e4m3fn")
NP_DTYPE = {"int8": np.int8, "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
            "float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _scales(rng):
    """Per-(layer, kv head) int8 scales, distinct per head."""
    return (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)


def _pools(rng, mode, ks, vs):
    """Random K/V pools of ``mode`` as numpy arrays (page 0 zero; int8
    codes at the per-head scales)."""
    out = []
    for sc in (ks, vs):
        x = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
        if mode == "int8":
            x = np.clip(np.round(x / sc[:, None, :, None, None]), -127, 127)
        x = x.astype(NP_DTYPE[mode])
        x[:, 0] = 0
        out.append(x)
    return out


def _t(x):
    """numpy → torch, byte-exact (e4m3 and bf16 through integer views)."""
    x = np.array(x)
    if x.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bytes(x):
    """Pool bytes as uint8, from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _scale_kw(mode, ks, vs, torch_side):
    if mode != "int8":
        return {}
    f = _t if torch_side else jnp.asarray
    return dict(k_scales=f(ks), v_scales=f(vs))


def _jax_all(cases, fn):
    """Run ``fn(mode, *arrays)`` for every mode's case in ONE JAX program."""
    flat = [(m, [jnp.asarray(a) for a in arrs]) for m, arrs in cases]
    sizes = [len(a) for _, a in flat]

    def run(*args):
        outs, i = [], 0
        for (m, _), n in zip(flat, sizes):
            outs.append(fn(m, *args[i:i + n]))
            i += n
        return outs

    return jax_lowest(run, *[a for _, arrs in flat for a in arrs])


def _decode_case(rng, mode):
    ks, vs = _scales(rng), _scales(rng)
    kp, vp = _pools(rng, mode, ks, vs)
    B = 4
    # row 0: a full page; row 1: slot on page 0 (write discarded); row 2:
    # zero length; row 3: short
    seq_lens = np.array([32, 27, 0, 9], np.int32)
    page_tables = np.array([[3], [2], [0], [7]], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages = page_tables[np.arange(B), pos // TP].astype(np.int32)
    slot_pages[1] = slot_pages[2] = 0
    slot_offsets = (pos % TP).astype(np.int32)
    q = rng.standard_normal((B, QH, D)).astype(np.float32)
    k_new = rng.standard_normal((B, KH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, KH, D)).astype(np.float32)
    return (q, kp, vp, page_tables, seq_lens, k_new, v_new, slot_pages,
            slot_offsets, ks, vs)


def test_decode_and_readonly_match_jax():
    """K1 (fused write, a window, a discarded slot, a zero-length row) and
    K1r over int8 and e4m3 pools."""
    rng = np.random.default_rng(0)
    window = 20
    cases = {m: _decode_case(rng, m) for m in MODES}

    def jfn(mode, q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs):
        sc = dict(k_scales=ks, v_scales=vs) if mode == "int8" else {}
        ro = j_paged_attention(q, kp, vp, pt, sl, 1, interpret=True, **sc)
        out, kp, vp = j_decode(q, kp, vp, pt, sl, 1, kn, vn, sp, so,
                               interpret=True, window=window, **sc)
        return out, ro, kp, vp

    got_j = _jax_all([(m, cases[m]) for m in MODES], jfn)
    for mode, (out_j, ro_j, kp_j, vp_j) in zip(MODES, got_j):
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, cases[mode])
        sc = _scale_kw(mode, cases[mode][9], cases[mode][10], True)
        ro_t = ops.paged_attention(q, kp, vp, pt, sl, 1, **sc)
        live = sl > 0
        np.testing.assert_allclose(ro_t.numpy()[live], np.asarray(ro_j)[live],
                                   atol=ATOL, rtol=0, err_msg=mode)
        out_t, kp_t, vp_t = ops.paged_attention_decode(
            q, kp, vp, pt, sl, 1, kn, vn, sp, so, window=window, **sc)
        assert kp_t.dtype == getattr(torch, mode)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j), err_msg=mode)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                                   rtol=0, err_msg=mode)
        assert out_t.dtype == torch.float32 and not out_t[2].any()


def test_prefill_write_quantizes_like_jax():
    """K2 into byte pools: the int8 write rounds half to even, clips at ±127
    and stores NaN as 0; e4m3 keeps 460 and 464 as 448 and turns 470 and -500 into NaN
    (the reference converts without saturating); a chunk aimed at the zero
    page is discarded."""
    rng = np.random.default_rng(1)
    T = 2 * TP
    pages = np.array([5, 0], np.int32)
    k_scale = np.array([0.5, 0.037], np.float32)
    v_scale = np.array([0.021, 0.5], np.float32)
    cases = []
    for mode in MODES:
        kp, vp = (np.zeros((L, P, KH, TP, D), NP_DTYPE[mode]) for _ in range(2))
        k_new = rng.standard_normal((KH, T, D)).astype(np.float32)
        v_new = rng.standard_normal((KH, T, D)).astype(np.float32)
        if mode == "int8":
            # x / 0.5 lands on .5: half to even; 100 / 0.5 = 200 clips
            k_new[0, 0, :6] = [0.25, 0.75, 1.25, -0.25, -0.75, 100.0]
            v_new[1, 3, :3] = [-100.0, 2.25, np.nan]
        else:
            k_new[0, 0, :5] = [460.0, 464.0, 470.0, -500.0, -464.0]
            v_new[1, 3, :2] = [np.inf, 1e-9]
        cases.append((mode, (kp, vp, k_new, v_new, pages, k_scale, v_scale)))

    def jfn(mode, kp, vp, kn, vn, pg, ksc, vsc):
        sc = dict(k_scale=ksc, v_scale=vsc) if mode == "int8" else {}
        return j_write_prefill_kv(kp, vp, kn, vn, pg, 1, interpret=True, **sc)

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), (kp_j, vp_j) in zip(cases, got_j):
        kp, vp, kn, vn, pg, ksc, vsc = map(_t, arrs)
        sc = dict(k_scale=ksc, v_scale=vsc) if mode == "int8" else {}
        kp_t, vp_t = ops.write_prefill_kv(kp, vp, kn, vn, pg, 1, **sc)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j), err_msg=mode)
        head = _bytes(kp_t)[1, 5, 0, 0, :6]
        if mode == "int8":
            assert head.view(np.int8).tolist() == [0, 2, 2, 0, -2, 127]
            assert _bytes(vp_t)[1, 5, 1, 3, :3].view(np.int8).tolist() == [-127, 4, 0]
        else:
            assert head[:5].tolist() == [0x7E, 0x7E, 0x7F, 0xFF, 0xFE]
            assert _bytes(vp_t)[1, 5, 1, 3, :2].tolist() == [0x7F, 0x00]
        assert not _bytes(kp_t)[:, 0].any(), "the zero page stays zero"


def test_prefill_attention_matches_jax():
    """K3 over byte pools: a row after a cached page (q_start > 0), a
    fresh row and a kv_len = 0 row; a window on the int8 pool."""
    rng = np.random.default_rng(2)
    N, T = 3, 16
    page_tables = np.array([[4], [2], [0]], np.int32)
    q_starts = np.array([16, 0, 0], np.int32)
    kv_lens = np.array([16 + 11, 13, 0], np.int32)
    windows = {"int8": 12, "float8_e4m3fn": None}
    cases = []
    for mode in MODES:
        ks, vs = _scales(rng), _scales(rng)
        kp, vp = _pools(rng, mode, ks, vs)
        q = rng.standard_normal((N, T, QH, D)).astype(np.float32)
        cases.append((mode, (q, kp, vp, page_tables, q_starts, kv_lens, ks, vs)))

    def jfn(mode, q, kp, vp, pt, qs, kl, ks, vs):
        sc = dict(k_scales=ks, v_scales=vs) if mode == "int8" else {}
        return j_prefill_batch(q, kp, vp, pt, qs, kl, 1, interpret=True,
                               window=windows[mode], **sc)

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), out_j in zip(cases, got_j):
        q, kp, vp, pt, qs, kl, ks, vs = map(_t, arrs)
        sc = _scale_kw(mode, arrs[6], arrs[7], True)
        out_t = ops.paged_prefill_attention_batch(
            q, kp, vp, pt, qs, kl, 1, window=windows[mode], **sc).numpy()
        out_j = np.asarray(out_j)
        for n in range(N):
            live = max(int(kv_lens[n] - q_starts[n]), 0)
            np.testing.assert_allclose(out_t[n, :live], out_j[n, :live],
                                       atol=ATOL, rtol=0, err_msg=mode)
        assert not out_t[2].any(), "a kv_len=0 row gives zeros"


def test_verify_matches_jax():
    """K4 over byte pools: T = 2 fed tokens, a discarded slot, a row
    overhanging its table and a padding row."""
    rng = np.random.default_rng(3)
    B, T, maxp = 4, 2, 1
    seq_lens = np.array([17, 20, maxp * TP + 1, 0], np.int32)
    page_tables = np.array([[3], [2], [6], [0]], np.int32)
    positions = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
    inside = positions < maxp * TP
    idx = np.minimum(positions, maxp * TP - 1) // TP
    slot_pages = np.where(inside, np.take_along_axis(page_tables, idx, 1), 0)
    slot_pages = slot_pages.astype(np.int32)
    slot_pages[1, 1] = 0
    slot_pages[3] = 0
    slot_offsets = (positions % TP).astype(np.int32)
    live = (seq_lens[:, None] - T + np.arange(T)[None] >= 0) & inside
    cases = []
    for mode in MODES:
        ks, vs = _scales(rng), _scales(rng)
        kp, vp = _pools(rng, mode, ks, vs)
        q = rng.standard_normal((B, T, QH, D)).astype(np.float32)
        kn = rng.standard_normal((B, T, KH, D)).astype(np.float32)
        vn = rng.standard_normal((B, T, KH, D)).astype(np.float32)
        cases.append((mode, (q, kp, vp, page_tables, seq_lens, kn, vn, slot_pages,
                             slot_offsets, ks, vs)))

    def jfn(mode, q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs):
        sc = dict(k_scales=ks, v_scales=vs) if mode == "int8" else {}
        return j_verify(q, kp, vp, pt, sl, 1, kn, vn, sp, so, interpret=True, **sc)

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), (out_j, kp_j, vp_j) in zip(cases, got_j):
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, arrs)
        sc = _scale_kw(mode, arrs[9], arrs[10], True)
        out_t, kp_t, vp_t = ops.paged_attention_verify(
            q, kp, vp, pt, sl, 1, kn, vn, sp, so, **sc)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j), err_msg=mode)
        np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                                   atol=ATOL, rtol=0, err_msg=mode)
        assert not out_t[3].any(), "a zero-length row gives zeros"
