"""The port's CUDA kernels (K1-K6, K3m) against their plain PyTorch versions, on
the card.  These tests carry the ``cuda`` marker and skip without a card (a
CUDA kernel has no CPU mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).

Tolerances: pool writes bit-exact; outputs within 1e-4 at float32 (TF32
off) and 2e-2 at bfloat16 (one bf16 ulp of unit-scale outputs is ~8e-3).
This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops
from kvcached_tpu_torch.ops.paged_attention import MLA_HEAD_DIM, MLA_V_DIM

L, P, KH, QH, TP, D = 2, 40, 2, 8, 16, 128
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(rng, dtype, dev):
    k = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    v = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    k[:, 0] = v[:, 0] = 0.0
    return (torch.from_numpy(k).to(dev, dtype), torch.from_numpy(v).to(dev, dtype))


def _decode_case(card, dtype, window):
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng, dtype, card)
    B, maxp = 4, 6
    pages = rng.permutation(np.arange(1, P))
    seq_lens = np.array([90, 33, 0, 7], np.int32)
    pt = np.zeros((B, maxp), np.int32)
    for b, s in enumerate(seq_lens):
        pt[b, : -(-s // TP)] = pages[b * maxp : b * maxp - (-s // TP)]
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages = pt[np.arange(B), pos // TP].copy()
    slot_pages[1:3] = 0  # row 1's write discarded; row 2 is padding
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    q = t(rng.standard_normal((B, QH, D)).astype(np.float32)).to(dtype)
    kn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(dtype)
    vn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(dtype)
    args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages), t((pos % TP).astype(np.int32)))
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_decode(q, kp, vp, *args, window=window)
    out_p, _, _ = ops.paged_attention_decode_plain(q, kp2, vp2, *args, window=window)
    ro_k = ops.paged_attention(q, kp, vp, args[0], args[1], 1, window=window)
    torch.cuda.synchronize()
    case = f"{dtype}, window {window}"
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2), case
    assert (out_k.float() - out_p.float()).abs().max().item() <= TOL[dtype], case
    assert (ro_k.float() - out_p.float()).abs().max().item() <= TOL[dtype], case
    assert not out_k[2].any(), case


@pytest.mark.cuda
def test_decode_kernel_matches_plain(card):
    for dtype in TOL:
        for window in (None, 24):
            _decode_case(card, dtype, window)


def _prefill_case(card, dtype):
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng, dtype, card)
    N, T, maxp = 3, 48, 6
    pages = rng.permutation(np.arange(1, P))
    pt = np.zeros((N, maxp), np.int32)
    pt[0, :6] = pages[:6]
    pt[1, :3] = pages[6:9]
    q_starts = np.array([48, 0, 0], np.int32)
    kv_lens = np.array([48 + 40, 41, 0], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    q = t(rng.standard_normal((N, T, QH, D)).astype(np.float32)).to(dtype)
    kn = t(rng.standard_normal((KH, T, D)).astype(np.float32)).to(dtype)
    vn = t(rng.standard_normal((KH, T, D)).astype(np.float32)).to(dtype)
    chunk = t(np.array([pages[30], 0, pages[31]], np.int32))
    kp2, vp2 = kp.clone(), vp.clone()
    ops.write_prefill_kv(kp, vp, kn, vn, chunk, 0)
    ops.write_prefill_kv_plain(kp2, vp2, kn, vn, chunk, 0)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2), dtype
    for window in (None, 24):
        case = f"{dtype}, window {window}"
        a = (q, kp, vp, t(pt), t(q_starts), t(kv_lens), 1)
        out_k = ops.paged_prefill_attention_batch(*a, window=window)
        out_p = ops.paged_prefill_attention_batch_plain(*a, window=window)
        for n in range(N):
            live = max(int(kv_lens[n] - q_starts[n]), 0)
            err = (out_k[n, :live].float() - out_p[n, :live].float()).abs()
            assert err.max().item() <= TOL[dtype] if live else True, case
        assert not out_k[2].any(), case
        one = ops.paged_prefill_attention(q[0], kp, vp, t(pt[0]), 48, 88, 1, window=window)
        assert torch.equal(one, out_k[0]), f"a batch row equals its N=1 call ({case})"


@pytest.mark.cuda
def test_prefill_kernels_match_plain(card):
    for dtype in TOL:
        _prefill_case(card, dtype)


def _verify_case(card, dtype, window):
    """K4 at T = 5 fed tokens, GQA group 4 (20 query rows): a long row, a
    discarded slot, a row overhanging its table by 2 < T, a padding row."""
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng, dtype, card)
    B, T, maxp = 4, 5, 6
    pages = rng.permutation(np.arange(1, P))
    seq_lens = np.array([90, 33, maxp * TP + 2, 0], np.int32)
    pt = np.zeros((B, maxp), np.int32)
    for b, s in enumerate(seq_lens):
        n = min(-(-s // TP), maxp)
        pt[b, :n] = pages[b * maxp : b * maxp + n]
    pos = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
    inside = pos < maxp * TP
    slot_pages = np.where(inside, np.take_along_axis(pt, np.minimum(pos // TP, maxp - 1), 1), 0)
    slot_pages[1, 2] = 0
    slot_pages[3] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    q = t(rng.standard_normal((B, T, QH, D)).astype(np.float32)).to(dtype)
    kn = t(rng.standard_normal((B, T, KH, D)).astype(np.float32)).to(dtype)
    vn = t(rng.standard_normal((B, T, KH, D)).astype(np.float32)).to(dtype)
    args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages.astype(np.int32)),
            t((pos % TP).astype(np.int32)))
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_verify(q, kp, vp, *args, window=window)
    out_p, _, _ = ops.paged_attention_verify_plain(q, kp2, vp2, *args, window=window)
    torch.cuda.synchronize()
    case = f"{dtype}, window {window}"
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2), case
    live = t((seq_lens[:, None] - T + np.arange(T)[None] >= 0) & inside)
    err = (out_k.float() - out_p.float())[live].abs().max().item()
    assert err <= TOL[dtype], case
    assert not out_k[3].any(), case


@pytest.mark.cuda
def test_verify_kernel_matches_plain(card):
    for dtype in TOL:
        for window in (None, 24):
            _verify_case(card, dtype, window)


def _mla_case(card, dtype):
    """K5 (decode), K5v (verify, T=5: a row overhanging its table by 2, a
    row whose writes are all discarded), K6 and K3m at DeepSeek-V2-Lite's
    widths: one latent kv head of 640 lanes, values its first 512, 16 query
    heads."""
    H, Dl, R = 16, MLA_HEAD_DIM, MLA_V_DIM
    scale = 192 ** -0.5
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    pool = rng.standard_normal((L, P, 1, TP, Dl)).astype(np.float32)
    pool[:, 0] = 0.0
    kp = t(pool).to(dtype)
    B, maxp = 4, 6
    pages = rng.permutation(np.arange(1, P))
    for T, seq_lens, pad in ((1, np.array([90, 33, 0, 7], np.int32), 2),
                             (5, np.array([90, 33, maxp * TP + 2, 0], np.int32), 3)):
        pt = np.zeros((B, maxp), np.int32)
        for b, s in enumerate(seq_lens):
            n = min(-(-s // TP), maxp)
            pt[b, :n] = pages[b * maxp: b * maxp + n]
        pos = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
        inside = pos < maxp * TP
        slot_pages = np.where(inside, np.take_along_axis(pt, np.minimum(pos // TP, maxp - 1), 1), 0)
        slot_pages[3] = 0
        q = t(rng.standard_normal((B, T, H, Dl)).astype(np.float32)).to(dtype)
        ent = t(rng.standard_normal((B, T, 1, Dl)).astype(np.float32)).to(dtype)
        args = (t(pt), t(seq_lens), 1)
        slots = (t(slot_pages.astype(np.int32)), t((pos % TP).astype(np.int32)))
        kp2 = kp.clone()
        if T == 1:
            out_k = ops.paged_attention_decode(q[:, 0], kp, None, *args, ent[:, 0], None,
                                               *(s[:, 0].contiguous() for s in slots),
                                               sm_scale=scale, mla_v_dim=R)[0][:, None]
            out_p = ops.paged_attention_decode_plain(
                q[:, 0], kp2, None, *args, ent[:, 0], None, *(s[:, 0] for s in slots),
                sm_scale=scale, mla_v_dim=R)[0][:, None]
        else:
            out_k = ops.paged_attention_verify(q, kp, None, *args, ent, None, *slots,
                                               sm_scale=scale, mla_v_dim=R)[0]
            out_p = ops.paged_attention_verify_plain(q, kp2, None, *args, ent, None, *slots,
                                                     sm_scale=scale, mla_v_dim=R)[0]
        torch.cuda.synchronize()
        case = f"{dtype}, T={T}"
        assert torch.equal(kp, kp2), case
        live = t((seq_lens[:, None] - T + np.arange(T)[None] >= 0) & inside)
        assert (out_k.float() - out_p.float())[live].abs().max().item() <= TOL[dtype], case
        assert not out_k[pad].any() and not out_k[..., R:].any(), case
    # K6, then K3m over a cached-prefix row, a fresh row and a kv_len = 0 row
    ent = t(rng.standard_normal((1, 3 * TP, Dl)).astype(np.float32)).to(dtype)
    chunk = t(np.array([pages[30], 0, pages[31]], np.int32))
    kp2 = kp.clone()
    ops.write_prefill_kv_single(kp, ent, chunk, 0)
    ops.write_prefill_kv_single_plain(kp2, ent, chunk, 0)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp2), dtype
    N, T = 3, 48
    pt = np.zeros((N, maxp), np.int32)
    pt[0, :6] = pages[:6]
    pt[1, :3] = pages[6:9]
    q_starts, kv_lens = np.array([48, 0, 0], np.int32), np.array([88, 41, 0], np.int32)
    q = t(rng.standard_normal((N, T, H, Dl)).astype(np.float32)).to(dtype)
    a = (q, kp, None, t(pt), t(q_starts), t(kv_lens), 1)
    out_k = ops.paged_prefill_attention_batch(*a, sm_scale=scale, mla_v_dim=R)
    out_p = ops.paged_prefill_attention_batch_plain(*a, sm_scale=scale, mla_v_dim=R)
    for n in range(N):
        live = max(int(kv_lens[n] - q_starts[n]), 0)
        if live:
            err = (out_k[n, :live].float() - out_p[n, :live].float()).abs().max().item()
            assert err <= TOL[dtype], dtype
    assert not out_k[2].any() and not out_k[..., R:].any(), dtype


@pytest.mark.cuda
def test_mla_kernels_match_plain(card):
    for dtype in TOL:
        _mla_case(card, dtype)
