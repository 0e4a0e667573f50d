"""The port's CUDA kernels over byte pools (int8 with per-head scales, and
float8_e4m3fn) against their plain PyTorch versions, on the card: K1 with
K1r, K2, K3 and K4, each test covering both byte types.  These tests carry
the ``cuda`` marker and skip without a card (a CUDA kernel has no CPU
mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py``.

Tolerances: pool writes bit-exact, compared as bytes (an e4m3 NaN never
equals itself); float32 outputs within 2e-2 (both sides take bf16 operands
but round the softmax weights against different running maxima and sum in
different orders).  This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, KH, QH, TP, D = 2, 40, 2, 8, 32, 128
MODES = (torch.int8, torch.float8_e4m3fn)
TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, dtype, seed):
    """(rng, tensor maker, K/V pools of ``dtype`` on the card, scale kwargs
    of the attention kernels): values ~N(0, 1) as the pool stores them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    scales = [t((0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)) for _ in range(2)]
    pools = []
    for sc in scales:
        x = t(rng.standard_normal((L, P, KH, TP, D)).astype(np.float32))
        x = ops.quantize_kv(x, dtype, sc[:, None, :, None, None])
        x[:, 0] = 0
        pools.append(x)
    kw = dict(k_scales=scales[0], v_scales=scales[1]) if dtype == torch.int8 else {}
    return rng, t, pools, kw


def _same_bytes(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
def test_decode_kernels_match_plain(card):
    """K1 (with and without a window; a row over three 256-key splits, a
    discarded write, a padding row) and K1r."""
    for dtype in MODES:
        rng, t, (kp, vp), kw = _case(card, dtype, 0)
        B, maxp = 4, 24
        seq_lens = np.array([700, 65, 0, 7], np.int32)
        pages = rng.permutation(np.arange(1, P))
        pt = np.zeros((B, maxp), np.int32)
        for b, s in enumerate(seq_lens):
            n = -(-s // TP)
            first = 0 if b == 0 else 22 + 4 * (b - 1)
            pt[b, :n] = pages[first:first + n]
        pos = np.maximum(seq_lens - 1, 0)
        slot_pages = pt[np.arange(B), pos // TP].copy()
        slot_pages[1:3] = 0
        q = t(rng.standard_normal((B, QH, D)).astype(np.float32))
        kn, vn = (t(rng.standard_normal((B, KH, D)).astype(np.float32)) for _ in range(2))
        for window in (None, 100):
            case = f"{dtype}, window {window}"
            args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages),
                    t((pos % TP).astype(np.int32)))
            kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            out_k, _, _ = ops.paged_attention_decode(q, kp1, vp1, *args, window=window, **kw)
            out_p, _, _ = ops.paged_attention_decode_plain(q, kp2, vp2, *args,
                                                           window=window, **kw)
            ro = ops.paged_attention(q, kp1, vp1, args[0], args[1], 1, window=window, **kw)
            torch.cuda.synchronize()
            assert _same_bytes(kp1, kp2) and _same_bytes(vp1, vp2), case
            assert out_k.dtype == torch.float32 and _err(out_k, out_p) <= TOL, case
            assert _err(ro, out_p) <= TOL and not out_k[2].any(), case


@pytest.mark.cuda
def test_prefill_write_matches_plain(card):
    """K2: the int8 writer rounds half to even, clips and stores NaN as 0;
    e4m3 keeps 460 and 464 as 448 and turns 470, -500, inf and NaN into
    NaN."""
    for dtype in MODES:
        rng, t, (kp, vp), _ = _case(card, dtype, 1)
        T = 3 * TP
        kn, vn = (rng.standard_normal((KH, T, D)).astype(np.float32) for _ in range(2))
        kn[0, 0, :8] = [0.25, 0.75, 1.25, -0.25, 100.0, 460.0, 464.0, 470.0]
        vn[1, 5, :3] = [-500.0, np.inf, np.nan]
        sc = dict(k_scale=t(np.array([0.5, 0.03], np.float32)),
                  v_scale=t(np.array([0.02, 0.5], np.float32)))
        sc = sc if dtype == torch.int8 else {}
        chunk = t(np.array([7, 0, 9], np.int32))
        kp2, vp2 = kp.clone(), vp.clone()
        ops.write_prefill_kv(kp, vp, t(kn), t(vn), chunk, 1, **sc)
        ops.write_prefill_kv_plain(kp2, vp2, t(kn), t(vn), chunk, 1, **sc)
        torch.cuda.synchronize()
        assert _same_bytes(kp, kp2) and _same_bytes(vp, vp2), dtype
        head = kp[1, 7, 0, 0, :8].view(torch.uint8).cpu().numpy()
        if dtype == torch.int8:
            assert head.view(np.int8)[:5].tolist() == [0, 2, 2, 0, 127]
            assert vp[1, 7, 1, 5, :3].tolist() == [-127, 127, 0]
        else:
            assert head[5:].tolist() == [0x7E, 0x7E, 0x7F]
            assert vp[1, 7, 1, 5, :3].view(torch.uint8).tolist() == [0xFF, 0x7F, 0x7F]


@pytest.mark.cuda
def test_prefill_attention_matches_plain(card):
    """K3: a row after three cached pages (q_start > 0), a fresh row and a
    kv_len = 0 row, with and without a window; a batch row equals its N=1
    call bitwise."""
    for dtype in MODES:
        rng, t, (kp, vp), kw = _case(card, dtype, 2)
        N, T, maxp = 3, 64, 6
        pt = np.zeros((N, maxp), np.int32)
        pt[0, :6] = [3, 9, 4, 12, 5, 20]
        pt[1, :2] = [30, 31]
        q_starts = np.array([96, 0, 0], np.int32)
        kv_lens = np.array([96 + 50, 41, 0], np.int32)
        q = t(rng.standard_normal((N, T, QH, D)).astype(np.float32))
        for window in (None, 40):
            case = f"{dtype}, window {window}"
            a = (q, kp, vp, t(pt), t(q_starts), t(kv_lens), 1)
            out_k = ops.paged_prefill_attention_batch(*a, window=window, **kw)
            out_p = ops.paged_prefill_attention_batch_plain(*a, window=window, **kw)
            for n in range(N):
                live = max(int(kv_lens[n] - q_starts[n]), 0)
                if live:
                    assert _err(out_k[n, :live], out_p[n, :live]) <= TOL, case
            assert out_k.dtype == torch.float32 and not out_k[2].any(), case
            one = ops.paged_prefill_attention(q[0], kp, vp, t(pt[0]), 96, 146, 1,
                                              window=window, **kw)
            assert torch.equal(one, out_k[0]), case


@pytest.mark.cuda
def test_verify_kernel_matches_plain(card):
    """K4 at T = 5 fed tokens, GQA group 4: a row over two splits, a
    discarded slot, a row overhanging its table by 2 < T, a padding row."""
    for dtype in MODES:
        rng, t, (kp, vp), kw = _case(card, dtype, 3)
        B, T, maxp = 4, 5, 10
        seq_lens = np.array([300, 40, maxp * TP + 2, 0], np.int32)
        pt = np.zeros((B, maxp), np.int32)
        pt[0] = np.arange(1, 11)
        pt[1, :2] = [11, 12]
        pt[2] = np.arange(13, 23)
        pos = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
        inside = pos < maxp * TP
        idx = np.minimum(pos, maxp * TP - 1) // TP
        slot_pages = np.where(inside, np.take_along_axis(pt, idx, 1), 0).astype(np.int32)
        slot_pages[1, 2] = 0
        slot_pages[3] = 0
        q = t(rng.standard_normal((B, T, QH, D)).astype(np.float32))
        kn, vn = (t(rng.standard_normal((B, T, KH, D)).astype(np.float32)) for _ in range(2))
        for window in (None, 64):
            case = f"{dtype}, window {window}"
            args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages),
                    t((pos % TP).astype(np.int32)))
            kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            out_k, _, _ = ops.paged_attention_verify(q, kp1, vp1, *args, window=window, **kw)
            out_p, _, _ = ops.paged_attention_verify_plain(q, kp2, vp2, *args,
                                                           window=window, **kw)
            torch.cuda.synchronize()
            assert _same_bytes(kp1, kp2) and _same_bytes(vp1, vp2), case
            live = torch.from_numpy((seq_lens[:, None] - T + np.arange(T)[None] >= 0)
                                    & inside).to(card)
            assert _err(out_k[live], out_p[live]) <= TOL, case
            assert not out_k[3].any(), case
