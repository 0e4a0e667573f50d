"""K7 and K8, the dp-replica equalizer's token writers, against their plain
PyTorch versions on the card, and the rewrite check there.  These tests
carry the ``cuda`` marker and skip without a card (a CUDA kernel has no CPU
mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_dp_cuda.py``.

K7 runs at head_dim 128 and 256 with identity pool layers and with four kv
layers sharing two pool layers (scales keyed by kv layer), K8 on a latent
pool of 640 lanes, each on float32, bf16, int8 and e4m3 pools (byte pools
from bf16 and from float32 tokens), with a discarded row.  The rewrite check: K1's fused write (K5's for the latent
pool), then K7 (K8) of the same tokens, leaves the pools' bytes unchanged.
Tolerance: none; pools are compared byte for byte.  This file imports
nothing of JAX.
"""

import pytest
import torch

from kvcached_tpu_torch import ops

P, TP, B = 24, 32, 5
DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _pool(g, dtype, L, KH, D, dev):
    x = torch.randn((L, P, KH, TP, D), generator=g, device=dev)
    x = ops.quantize_kv(x, dtype, 0.05 if dtype == torch.int8 else None)
    x[:, 0] = 0
    return x


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _case(g, dev, Lk, shared):
    """pool_layers, slot_pages [Lk, B] (row 3 discarded; with ``shared``
    the kv layers of one parity share a pool layer, on distinct pages) and
    slot_offsets."""
    if shared:
        pool_layers = torch.arange(Lk, dtype=torch.int32, device=dev) % 2
        pages = (torch.randperm(P - 1, generator=g, device=dev)[:Lk * B] + 1).reshape(Lk, B)
    else:
        pool_layers = torch.arange(Lk, dtype=torch.int32, device=dev)
        pages = (torch.randperm(P - 1, generator=g, device=dev)[:B] + 1)[None].expand(Lk, B)
    pages = pages.to(torch.int32).contiguous()
    pages[:, 3] = 0
    offsets = torch.randint(0, TP, (B,), generator=g, device=dev, dtype=torch.int32)
    return pool_layers, pages, offsets


@pytest.mark.cuda
def test_k7_k8_match_plain(card):
    g = torch.Generator(device=card).manual_seed(0)
    for dtype in DTYPES:
        byte = dtype.itemsize == 1
        for D, shared in ((128, False), (128, True), (256, True)):
            # the tokens' type: the pool's, bf16 or (the shared case at 128) float32
            # for byte pools
            io = (torch.float32 if shared and D == 128 else torch.bfloat16) if byte else dtype
            L, KH = 2, 4
            Lk = 4 if shared else L
            kp, vp = _pool(g, dtype, L, KH, D, card), _pool(g, dtype, L, KH, D, card)
            kn, vn = (torch.randn((Lk, B, KH, D), generator=g, device=card).to(io)
                      for _ in range(2))
            pl, sp, so = _case(g, card, Lk, shared)
            sc = {}
            if dtype == torch.int8:
                rows = Lk if shared else L  # keyed by kv layer when shared
                sc = {k: 0.02 + 0.03 * torch.rand((rows, KH), generator=g, device=card)
                      for k in ("k_scales", "v_scales")}
            want = ops.write_decode_tokens_plain(kp.clone(), vp.clone(), kn, vn, pl, sp, so,
                                                 **sc)
            n = ops.write_decode_tokens.launches
            got = ops.write_decode_tokens(kp, vp, kn, vn, pl, sp, so, **sc)
            torch.cuda.synchronize()
            assert ops.write_decode_tokens.launches == n + 1
            for a, b in zip(got, want):
                assert torch.equal(_bytes(a), _bytes(b)), (dtype, D, shared)
        io = torch.bfloat16 if byte else dtype
        lp = _pool(g, dtype, 3, 1, 640, card)
        ln = torch.randn((3, B, 1, 640), generator=g, device=card).to(io)
        pl, sp, so = _case(g, card, 3, False)
        sc = {"k_scales": torch.full((3, 1), 0.04, device=card)} if dtype == torch.int8 else {}
        want = ops.write_decode_tokens_single_plain(lp.clone(), ln, pl, sp, so, **sc)
        got = ops.write_decode_tokens_single(lp, ln, pl, sp, so, **sc)
        torch.cuda.synchronize()
        assert torch.equal(_bytes(got), _bytes(want)), dtype


@pytest.mark.cuda
def test_rewrite_after_fused_write_keeps_bytes(card):
    """K1 (K5) writes each layer's token, then K7 (K8) rewrites them."""
    g = torch.Generator(device=card).manual_seed(1)
    L, KH, H, D = 2, 4, 8, 128
    pt = (torch.randperm(P - 1, generator=g, device=card)[:B * 2] + 1).reshape(B, 2)
    pt = pt.to(torch.int32).contiguous()
    seq_lens = torch.tensor([40, 33, 9, 64, 1], dtype=torch.int32, device=card)
    pos = (seq_lens - 1).long()
    sp = pt[torch.arange(B, device=card), pos // TP].contiguous()
    sp[3] = 0
    so = (pos % TP).to(torch.int32)
    pl = torch.arange(L, dtype=torch.int32, device=card)
    pages = sp[None].expand(L, B).contiguous()
    for dtype in DTYPES:
        io = torch.float32 if dtype == torch.float32 else torch.bfloat16
        kp, vp = _pool(g, dtype, L, KH, D, card), _pool(g, dtype, L, KH, D, card)
        lp = _pool(g, dtype, L, 1, 640, card)
        sc = {k: torch.full((L, KH), 0.05, device=card) for k in ("k_scales", "v_scales")} \
            if dtype == torch.int8 else {}
        lsc = {"k_scales": torch.full((L, 1), 0.05, device=card)} if dtype == torch.int8 else {}
        kn, vn = (torch.randn((L, B, KH, D), generator=g, device=card).to(io) for _ in range(2))
        ln = torch.randn((L, B, 1, 640), generator=g, device=card).to(io)
        for layer in range(L):
            ops.paged_attention_decode(torch.randn((B, H, D), device=card).to(io), kp, vp, pt,
                                       seq_lens, layer, kn[layer], vn[layer], sp, so, **sc)
            ops.paged_attention_decode(torch.randn((B, 16, 640), device=card).to(io), lp, None,
                                       pt, seq_lens, layer, ln[layer], None, sp, so,
                                       mla_v_dim=512, **lsc)
        before = [p.clone() for p in (kp, vp, lp)]
        ops.write_decode_tokens(kp, vp, kn, vn, pl, pages, so, **sc)
        ops.write_decode_tokens_single(lp, ln, pl, pages, so, **lsc)
        torch.cuda.synchronize()
        for a, b in zip((kp, vp, lp), before):
            assert torch.equal(_bytes(a), _bytes(b)), dtype
