"""Plain versions of the port's MLA kernels over byte latent pools (int8
with one scale a layer, and float8_e4m3fn) against the JAX package's Pallas
kernels in their MLA mode, run with ``interpret=True``, on the same numpy
inputs: K5 decode, K5 verify (K5v), and K6 followed by K3m, each test
covering both byte types; and the wrappers' contract for byte latent pools.

Widths are ``MLAConfig.toy``'s (one latent kv head of 256 lanes, values its
first 128, 4 query heads); pages hold 32 tokens (the byte pools' granule)
and the attention kernels' page tables one page.  The JAX kernels run with
one page a DMA chunk (``pages_per_chunk=1``, a tiling choice that leaves
the function unchanged), each test's JAX calls compiled as one program at
XLA's lowest optimisation level.

Tolerances: written pools are bit-equal, compared as bytes (an e4m3 NaN
never equals itself); outputs agree within atol 1e-5 at float32 inputs,
since both sides round q and the softmax weights to bf16 operands at the
same places and differ only in summation order.

The CUDA kernels themselves run only on the card:
tests/test_torch_mla_quant_cuda.py holds them against these plain versions.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.ops.paged_attention import paged_attention_decode as j_decode
from kvcached_tpu.ops.paged_attention import paged_attention_verify as j_verify
from kvcached_tpu.ops.paged_attention import write_prefill_kv_single as j_write_single
from kvcached_tpu.ops.paged_prefill import paged_prefill_attention_batch as j_prefill
from kvcached_tpu_torch import ops
from test_torch_quant_ops import MODES, NP_DTYPE, _bytes, _jax_all, _t

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, QH, TP, D, R = 2, 8, 4, 32, 256, 128
SCALE = 1.0 / np.sqrt(128.0)  # the toy's 1 / sqrt(qk_nope + qk_rope)


def _scales(rng):
    """One int8 scale a layer, [L, 1]: the latent pool's K scales."""
    return (0.02 + 0.03 * rng.random((L, 1))).astype(np.float32)


def _pool(rng, mode, ks):
    """A random latent pool of ``mode`` (page 0 zero), as numpy."""
    x = rng.standard_normal((L, P, 1, TP, D)).astype(np.float32)
    if mode == "int8":
        x = np.clip(np.round(x / ks[:, None, :, None, None]), -127, 127)
    x = x.astype(NP_DTYPE[mode])
    x[:, 0] = 0
    return x


def _scale_kw(mode, ks, jax_side):
    """The attention kernels' scales: an int8 pool's K scales, and its V
    scales (the same numbers: the JAX kernels read only the K scales in
    the MLA mode, and so do the port's)."""
    if mode != "int8":
        return {}
    f = jnp.asarray if jax_side else _t
    return dict(k_scales=f(ks), v_scales=f(ks))


def test_decode_matches_jax():
    """K5 over int8 and e4m3 latent pools: a full page, a write aimed at
    the zero page (discarded), a zero-length row and a short row."""
    rng = np.random.default_rng(0)
    B = 4
    seq_lens = np.array([32, 27, 0, 9], np.int32)
    page_tables = np.array([[3], [2], [0], [7]], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages = page_tables[np.arange(B), pos // TP].astype(np.int32)
    slot_pages[1] = slot_pages[2] = 0
    slot_offsets = (pos % TP).astype(np.int32)
    cases = []
    for mode in MODES:
        ks = _scales(rng)
        q = rng.standard_normal((B, QH, D)).astype(np.float32)
        ent = rng.standard_normal((B, 1, D)).astype(np.float32)
        cases.append((mode, (q, _pool(rng, mode, ks), page_tables, seq_lens, ent,
                             slot_pages, slot_offsets, ks)))

    def jfn(mode, q, kp, pt, sl, ent, sp, so, ks):
        out, kp, _ = j_decode(q, kp, kp, pt, sl, 1, ent, ent, sp, so, sm_scale=SCALE,
                              mla_v_dim=R, interpret=True, pages_per_chunk=1,
                              **_scale_kw(mode, ks, True))
        return out, kp

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), (out_j, kp_j) in zip(cases, got_j):
        q, kp, pt, sl, ent, sp, so, _ = map(_t, arrs)
        out_t, kp_t, vp_t = ops.paged_attention_decode(
            q, kp, None, pt, sl, 1, ent, None, sp, so, sm_scale=SCALE, mla_v_dim=R,
            **_scale_kw(mode, arrs[7], False))
        assert vp_t is None and kp_t.dtype == getattr(torch, mode)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0,
                                   err_msg=mode)
        assert out_t.dtype == torch.float32 and not out_t[2].any()
        assert not out_t[..., R:].any(), "lanes past the values are zero"


def test_verify_matches_jax():
    """K5v over byte latent pools: T = 2 fed tokens, a discarded slot, a
    row overhanging its table and a padding row."""
    rng = np.random.default_rng(1)
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
        ks = _scales(rng)
        q = rng.standard_normal((B, T, QH, D)).astype(np.float32)
        ent = rng.standard_normal((B, T, 1, D)).astype(np.float32)
        cases.append((mode, (q, _pool(rng, mode, ks), page_tables, seq_lens, ent,
                             slot_pages, slot_offsets, ks)))

    def jfn(mode, q, kp, pt, sl, ent, sp, so, ks):
        out, kp, _ = j_verify(q, kp, kp, pt, sl, 1, ent, ent, sp, so, sm_scale=SCALE,
                              mla_v_dim=R, interpret=True, pages_per_chunk=1,
                              **_scale_kw(mode, ks, True))
        return out, kp

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), (out_j, kp_j) in zip(cases, got_j):
        q, kp, pt, sl, ent, sp, so, _ = map(_t, arrs)
        out_t, kp_t, _ = ops.paged_attention_verify(
            q, kp, None, pt, sl, 1, ent, None, sp, so, sm_scale=SCALE, mla_v_dim=R,
            **_scale_kw(mode, arrs[7], False))
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                                   atol=ATOL, rtol=0, err_msg=mode)
        assert not out_t[3].any(), "a zero-length row gives zeros"


def test_prefill_write_and_attend_match_jax():
    """K6 quantizes a two-page latent chunk (its second page discarded)
    with the reference's edge values: int8 halfway steps (half to even),
    clipping and NaN (stored as 0); e4m3 460 and 464 (448), 470 and -500
    (NaN: no saturation), all in the page's last slot.  K3m then attends
    the written page below that slot: a row after a cached prefix (q_start
    > 0), a fresh row and a kv_len = 0 row."""
    rng = np.random.default_rng(2)
    T = 2 * TP
    pages = np.array([5, 0], np.int32)
    N, Tq = 3, 16
    page_tables = np.array([[5], [2], [0]], np.int32)
    q_starts = np.array([16, 0, 0], np.int32)
    kv_lens = np.array([16 + 11, 13, 0], np.int32)
    cases = []
    for mode in MODES:
        ks = _scales(rng)
        ks[1, 0] = 0.5
        ent = rng.standard_normal((1, T, D)).astype(np.float32)
        if mode == "int8":
            # x / 0.5 lands on .5: half to even; 100 / 0.5 = 200 clips
            ent[0, TP - 1, :7] = [0.25, 0.75, 1.25, -0.25, -0.75, 100.0, np.nan]
        else:
            ent[0, TP - 1, :5] = [460.0, 464.0, 470.0, -500.0, -464.0]
        q = rng.standard_normal((N, Tq, QH, D)).astype(np.float32)
        cases.append((mode, (_pool(rng, mode, ks), ent, pages, ks, q, page_tables,
                             q_starts, kv_lens)))

    def jfn(mode, kp, ent, pg, ks, q, pt, qs, kl):
        sc = dict(scale=ks[1]) if mode == "int8" else {}
        kp = j_write_single(kp, ent, pg, 1, interpret=True, **sc)
        out = j_prefill(q, kp, kp, pt, qs, kl, 1, sm_scale=SCALE, mla_v_dim=R,
                        interpret=True, pages_per_chunk=1, **_scale_kw(mode, ks, True))
        return kp, out

    got_j = _jax_all(cases, jfn)
    for (mode, arrs), (kp_j, out_j) in zip(cases, got_j):
        kp, ent, pg, ks, q, pt, qs, kl = map(_t, arrs)
        sc = dict(scale=ks[1]) if mode == "int8" else {}
        kp_t = ops.write_prefill_kv_single(kp, ent, pg, 1, **sc)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        head = _bytes(kp_t)[1, 5, 0, TP - 1, :7]
        if mode == "int8":
            assert head.view(np.int8).tolist() == [0, 2, 2, 0, -2, 127, 0]
        else:
            assert head[:5].tolist() == [0x7E, 0x7E, 0x7F, 0xFF, 0xFE]
        assert not _bytes(kp_t)[:, 0].any(), "the zero page stays zero"
        out_t = ops.paged_prefill_attention_batch(
            q, kp_t, None, pt, qs, kl, 1, sm_scale=SCALE, mla_v_dim=R,
            **_scale_kw(mode, arrs[3], False)).numpy()
        out_j = np.asarray(out_j)
        for n in range(N):
            live = max(int(kv_lens[n] - q_starts[n]), 0)
            np.testing.assert_allclose(out_t[n, :live], out_j[n, :live],
                                       atol=ATOL, rtol=0, err_msg=mode)
        assert not out_t[2].any(), "a kv_len=0 row gives zeros"


def test_byte_latent_wrapper_contract(monkeypatch):
    """Byte latent pools on the CPU run the plain versions (and count no
    launch); int8 scales must be [L, 1] (ValueError), K6 into an int8 pool
    needs the layer's scale; a window still raises NotImplementedError.  A
    CUDA call of each byte mode launches the kernel or raises (here: a
    refused build), never running a plain version."""
    rng = np.random.default_rng(3)
    ks = _t(_scales(rng))
    pt, sl = torch.tensor([[1], [2]], dtype=torch.int32), torch.tensor([5, 9], dtype=torch.int32)
    sp = torch.tensor([1, 0], dtype=torch.int32)
    q, ent = torch.randn(2, QH, D), torch.randn(2, 1, D)
    before = ops.launch_counts()
    for mode in MODES:
        kp = _t(_pool(rng, mode, _scales(rng)))
        kw = dict(k_scales=ks, v_scales=ks) if mode == "int8" else {}
        out, _, _ = ops.paged_attention_decode(q, kp.clone(), None, pt, sl, 0, ent, None, sp,
                                               sl, sm_scale=SCALE, mla_v_dim=R, **kw)
        want = ops.paged_attention_decode_plain(q, kp.clone(), None, pt, sl, 0, ent, None,
                                                sp, sl, sm_scale=SCALE, mla_v_dim=R, **kw)[0]
        assert torch.equal(out, want), mode
        with pytest.raises(NotImplementedError, match="window"):
            ops.paged_attention_decode(q, kp, None, pt, sl, 0, ent, None, sp, sl,
                                       mla_v_dim=R, window=8, **kw)
    kp = _t(_pool(rng, "int8", ks.numpy()))
    for bad in (torch.ones(L, 2), torch.ones(L), torch.ones(L + 1, 1)):
        with pytest.raises(ValueError, match="scales"):
            ops.paged_attention_decode(q, kp, None, pt, sl, 0, ent, None, sp, sl,
                                       mla_v_dim=R, k_scales=bad, v_scales=ks)
        with pytest.raises(ValueError, match="scales"):
            ops.paged_prefill_attention_batch(torch.zeros(2, TP, QH, D), kp, None, pt, sl,
                                              sl, 0, mla_v_dim=R, v_scales=bad)
    with pytest.raises(ValueError, match="scale"):
        ops.write_prefill_kv_single(kp, torch.zeros(1, TP, D), sp[:1], 0)
    with pytest.raises(ValueError, match="scale"):
        ops.write_prefill_kv_single(kp, torch.zeros(1, TP, D), sp[:1], 0, scale=ks[0, :1].repeat(2))
    assert ops.launch_counts() == before

    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")
    pp = importlib.import_module("kvcached_tpu_torch.ops.paged_prefill")
    from kvcached_tpu_torch.ops import _build

    def no_build(name):
        raise RuntimeError("build refused")

    monkeypatch.setattr(_build, "load", no_build)
    for mod in (pa, pp):
        monkeypatch.setattr(mod, "_on_cpu", lambda *ts: False)
    calls = []
    for mod, name in ((pa, "paged_attention_decode_plain"), (pa, "paged_attention_verify_plain"),
                      (pa, "write_prefill_kv_single_plain"),
                      (pp, "paged_prefill_attention_batch_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(a))
    Dw, H = pa.MLA_HEAD_DIM, 16  # DeepSeek-V2's widths: the kernels take them
    for mode in MODES:
        kw_pool = torch.zeros(L, 4, 1, TP, Dw).to(getattr(torch, mode))
        sc = dict(k_scales=ks, v_scales=ks) if mode == "int8" else {}
        ew = torch.zeros(2, 1, Dw)
        runs = (
            lambda: pa.paged_attention_decode(torch.zeros(2, H, Dw), kw_pool, None, pt, sl, 0,
                                              ew, None, sp, sp, mla_v_dim=pa.MLA_V_DIM, **sc),
            lambda: pa.paged_attention_verify(
                torch.zeros(2, 3, H, Dw), kw_pool, None, pt, sl, 0, torch.zeros(2, 3, 1, Dw),
                None, sp[:, None].repeat(1, 3), sp[:, None].repeat(1, 3),
                mla_v_dim=pa.MLA_V_DIM, **sc),
            lambda: pp.paged_prefill_attention_batch(torch.zeros(2, TP, H, Dw), kw_pool, None,
                                                     pt, sp, sl, 0, mla_v_dim=pa.MLA_V_DIM, **sc),
            lambda: pa.write_prefill_kv_single(kw_pool, torch.zeros(1, TP, Dw), sp[:1] + 1, 0,
                                               **({"scale": ks[0]} if sc else {})),
        )
        for run in runs:
            with pytest.raises(RuntimeError, match="build refused"):
                run()
    assert not calls, "no plain version ran"
    assert ops.launch_counts() == before
