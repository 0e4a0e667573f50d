"""The port's MLA CUDA kernels over byte latent pools (int8 with one scale a
layer, and float8_e4m3fn) against their plain PyTorch versions, on the
card, at DeepSeek-V2's widths (one latent kv head of 640 lanes, values the
first 512, 16 query heads): K5 decode, K5v verify, K6 and K3m, each test
covering both byte types.  These tests carry the ``cuda`` marker and skip
without a card (a CUDA kernel has no CPU mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_mla_quant_cuda.py``.

Tolerances: pool writes bit-exact, compared as bytes (an e4m3 NaN never
equals itself); outputs within 2e-2 (both sides take bf16 operands but
round the softmax weights against different running maxima and sum in
different orders).  This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, H, TP, D, R = 2, 48, 16, 32, 640, 512
SCALE = 192 ** -0.5  # DeepSeek-V2's 1 / sqrt(qk_nope + qk_rope)
#: byte pool type, and the type q and the new entries come in (a bf16 and a
#: float32 model)
MODES = ((torch.int8, torch.bfloat16), (torch.float8_e4m3fn, torch.float32))
TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, dtype, seed):
    """(rng, tensor maker, a latent pool of ``dtype`` on the card, scale
    kwargs of the attention kernels): values ~N(0, 1) as the pool stores
    them, int8 with one scale a layer."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    ks = t((0.02 + 0.03 * rng.random((L, 1))).astype(np.float32))
    x = t(rng.standard_normal((L, P, 1, TP, D)).astype(np.float32))
    pool = ops.quantize_kv(x, dtype, ks[:, None, :, None, None])
    pool[:, 0] = 0
    kw = dict(k_scales=ks, v_scales=ks) if dtype == torch.int8 else {}
    return rng, t, pool, kw


def _tables(rng, seq_lens, maxp):
    pages = rng.permutation(np.arange(1, P))
    pt = np.zeros((len(seq_lens), maxp), np.int32)
    used = 0
    for b, s in enumerate(seq_lens):
        n = min(-(-int(s) // TP), maxp)
        pt[b, :n] = pages[used:used + n]
        used += n
    return pt


def _same_bytes(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
def test_decode_kernel_matches_plain(card):
    """K5: a 700-token row (several key splits), a write aimed at the zero
    page, a padding row and a short row."""
    for dtype, io in MODES:
        rng, t, kp, kw = _case(card, dtype, 0)
        B, maxp = 4, 24
        seq_lens = np.array([700, 65, 0, 7], np.int32)
        pt = _tables(rng, seq_lens, maxp)
        pos = np.maximum(seq_lens - 1, 0)
        slot_pages = pt[np.arange(B), pos // TP].copy()
        slot_pages[1:3] = 0
        q = t(rng.standard_normal((B, H, D)).astype(np.float32)).to(io)
        ent = t(rng.standard_normal((B, 1, D)).astype(np.float32)).to(io)
        args = (t(pt), t(seq_lens), 1, ent, None, t(slot_pages), t((pos % TP).astype(np.int32)))
        kp1, kp2 = kp.clone(), kp.clone()
        before = ops.paged_attention_decode_mla.launches_by_dtype.get(str(dtype)[6:], 0)
        out_k, _, _ = ops.paged_attention_decode(q, kp1, None, *args, sm_scale=SCALE,
                                                 mla_v_dim=R, **kw)
        out_p, _, _ = ops.paged_attention_decode_plain(q, kp2, None, *args, sm_scale=SCALE,
                                                       mla_v_dim=R, **kw)
        torch.cuda.synchronize()
        assert ops.paged_attention_decode_mla.launches_by_dtype[str(dtype)[6:]] == before + 1
        assert _same_bytes(kp1, kp2), dtype
        assert out_k.dtype == io and _err(out_k, out_p) <= TOL, dtype
        assert not out_k[2].any() and not out_k[..., R:].any(), dtype


@pytest.mark.cuda
def test_verify_kernel_matches_plain(card):
    """K5v at T = 5 fed tokens (80 query rows, two query tiles): a row over
    several splits, a discarded slot, a row overhanging its table by 2 < T
    and a padding row."""
    for dtype, io in MODES:
        rng, t, kp, kw = _case(card, dtype, 1)
        B, T, maxp = 4, 5, 12
        seq_lens = np.array([300, 40, maxp * TP + 2, 0], np.int32)
        pt = _tables(rng, seq_lens, maxp)
        pos = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
        inside = pos < maxp * TP
        idx = np.minimum(pos, maxp * TP - 1) // TP
        slot_pages = np.where(inside, np.take_along_axis(pt, idx, 1), 0).astype(np.int32)
        slot_pages[1, 2] = 0
        slot_pages[3] = 0
        q = t(rng.standard_normal((B, T, H, D)).astype(np.float32)).to(io)
        ent = t(rng.standard_normal((B, T, 1, D)).astype(np.float32)).to(io)
        args = (t(pt), t(seq_lens), 1, ent, None, t(slot_pages), t((pos % TP).astype(np.int32)))
        kp1, kp2 = kp.clone(), kp.clone()
        out_k, _, _ = ops.paged_attention_verify(q, kp1, None, *args, sm_scale=SCALE,
                                                 mla_v_dim=R, **kw)
        out_p, _, _ = ops.paged_attention_verify_plain(q, kp2, None, *args, sm_scale=SCALE,
                                                       mla_v_dim=R, **kw)
        torch.cuda.synchronize()
        assert _same_bytes(kp1, kp2), dtype
        live = torch.from_numpy((seq_lens[:, None] - T + np.arange(T)[None] >= 0)
                                & inside).to(card)
        assert _err(out_k[live], out_p[live]) <= TOL, dtype
        assert not out_k[3].any(), dtype


@pytest.mark.cuda
def test_prefill_write_quantizes_like_plain(card):
    """K6 into byte latent pools, a three-page chunk with its middle page
    discarded: the int8 writer rounds half to even, clips at ±127 and
    stores NaN as 0; e4m3 keeps 460 and 464 as 448 (and -464 as -448) and
    turns 470, -500, inf and NaN into NaN (no saturation)."""
    for dtype, _ in MODES:
        rng, t, kp, _ = _case(card, dtype, 2)
        T = 3 * TP
        ent = rng.standard_normal((1, T, D)).astype(np.float32)
        ent[0, 0, :10] = [0.25, 0.75, 1.25, -0.25, 100.0, np.nan, 460.0, 464.0, 470.0, -464.0]
        ent[0, 5, :3] = [-500.0, np.inf, np.nan]
        sc = dict(scale=t(np.array([0.5], np.float32))) if dtype == torch.int8 else {}
        pages = t(np.array([7, 0, 9], np.int32))
        kp2 = kp.clone()
        ops.write_prefill_kv_single(kp, t(ent), pages, 1, **sc)
        ops.write_prefill_kv_single_plain(kp2, t(ent), pages, 1, **sc)
        torch.cuda.synchronize()
        assert _same_bytes(kp, kp2), dtype
        head = kp[1, 7, 0, 0, :10].view(torch.uint8).cpu().numpy()
        row5 = kp[1, 7, 0, 5, :3].view(torch.uint8).cpu().numpy()
        if dtype == torch.int8:
            assert head.view(np.int8)[:6].tolist() == [0, 2, 2, 0, 127, 0]
            assert row5.view(np.int8).tolist() == [-127, 127, 0]
        else:
            assert head[6:].tolist() == [0x7E, 0x7E, 0x7F, 0xFE]
            assert row5.tolist() == [0xFF, 0x7F, 0x7F]


@pytest.mark.cuda
def test_prefill_attention_matches_plain(card):
    """K3m: a row after three cached pages (q_start > 0), a fresh row and a
    kv_len = 0 row; a batch row equals its N=1 call bitwise."""
    for dtype, io in MODES:
        rng, t, kp, kw = _case(card, dtype, 3)
        N, T, maxp = 3, 64, 6
        pt = np.zeros((N, maxp), np.int32)
        pt[0, :6] = [3, 9, 4, 12, 5, 20]
        pt[1, :2] = [30, 31]
        q_starts = np.array([96, 0, 0], np.int32)
        kv_lens = np.array([96 + 50, 41, 0], np.int32)
        q = t(rng.standard_normal((N, T, H, D)).astype(np.float32)).to(io)
        a = (q, kp, None, t(pt), t(q_starts), t(kv_lens), 1)
        out_k = ops.paged_prefill_attention_batch(*a, sm_scale=SCALE, mla_v_dim=R, **kw)
        out_p = ops.paged_prefill_attention_batch_plain(*a, sm_scale=SCALE, mla_v_dim=R, **kw)
        for n in range(N):
            live = max(int(kv_lens[n] - q_starts[n]), 0)
            if live:
                assert _err(out_k[n, :live], out_p[n, :live]) <= TOL, dtype
        assert out_k.dtype == io and not out_k[2].any(), dtype
        one = ops.paged_prefill_attention(q[0], kp, None, t(pt[0]), 96, 146, 1,
                                          sm_scale=SCALE, mla_v_dim=R, **kw)
        assert torch.equal(one, out_k[0]), dtype
