"""Soft-capped K1 and K3 against their plain PyTorch versions on the card,
and the hybrid model's steps through the kernels against their plain path.
These tests carry the ``cuda`` marker and skip without a card (a CUDA
kernel has no CPU mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_hybrid_cuda.py``.

The queries are scaled so that the scores reach several times the cap, and
each case checks that the uncapped output lies far outside the tolerance.
Tolerances: pool writes bit-exact; outputs within 1e-4 at float32 (TF32
off) and 2e-2 at bfloat16 and on int8 pools (bf16 operands, one bf16 ulp of
a unit-scale output is ~8e-3); the toy model's last-position logits within
1e-4 at float32.  This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops

L, P, KH, QH, TP, D = 2, 40, 2, 8, 32, 128
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2}
CAP, SM_SCALE = 5.0, 144 ** -0.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rng, dtype, dev):
    """Pools of ``dtype`` (page 0 zero; int8 with per-head scales), the
    type q and new K/V come in, and the int8 scale keywords."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kw, pools = {}, []
    scales = [(0.02 + 0.03 * rng.random((L, KH))).astype(np.float32) for _ in range(2)]
    for sc in scales:
        x = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
        if dtype == torch.int8:
            x = np.clip(np.round(x / sc[:, None, :, None, None]), -127, 127)
        x[:, 0] = 0
        pools.append(t(x).to(dtype))
    if dtype == torch.int8:
        kw = dict(k_scales=t(scales[0]), v_scales=t(scales[1]))
    io = torch.bfloat16 if dtype == torch.int8 else dtype
    return pools, io, kw, t


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
def test_softcap_decode_kernel_matches_plain(card):
    """K1 with soft-capping: a long row, a discarded write, a zero-length
    row, a short row; windows none and 40; float32, bf16 and int8 pools."""
    for dtype in TOL:
        rng = np.random.default_rng(0)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        B, maxp = 4, 6
        pages = rng.permutation(np.arange(1, P))
        seq_lens = np.array([180, 70, 0, 9], np.int32)
        pt = np.zeros((B, maxp), np.int32)
        for b, s in enumerate(seq_lens):
            pt[b, : -(-s // TP)] = pages[b * maxp: b * maxp - (-s // TP)]
        pos = np.maximum(seq_lens - 1, 0)
        slot_pages = pt[np.arange(B), pos // TP].copy()
        slot_pages[1:3] = 0
        q = (4 * t(rng.standard_normal((B, QH, D)).astype(np.float32))).to(io)
        kn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(io)
        vn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(io)
        args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages), t((pos % TP).astype(np.int32)))
        for window in (None, 40):
            case = f"{dtype}, window {window}"
            kp2, vp2 = kp.clone(), vp.clone()
            before = ops.paged_attention_decode.launches_by_dtype.copy()
            out_k, _, _ = ops.paged_attention_decode(q, kp, vp, *args, window=window,
                                                     sm_scale=SM_SCALE, logit_softcap=CAP, **kw)
            out_p, _, _ = ops.paged_attention_decode_plain(
                q, kp2, vp2, *args, window=window, sm_scale=SM_SCALE, logit_softcap=CAP, **kw)
            uncapped = ops.paged_attention_decode_plain(
                q, kp2.clone(), vp2.clone(), *args, window=window, sm_scale=SM_SCALE, **kw)[0]
            torch.cuda.synchronize()
            key = str(dtype).replace("torch.", "") + "+softcap"
            assert ops.paged_attention_decode.launches_by_dtype[key] == before.get(key, 0) + 1
            assert torch.equal(kp.view(torch.uint8), kp2.view(torch.uint8)), case
            assert torch.equal(vp.view(torch.uint8), vp2.view(torch.uint8)), case
            assert _err(out_k, out_p) <= TOL[dtype], case
            assert _err(uncapped, out_p) > 10 * TOL[dtype], f"the cap matters ({case})"
            assert not out_k[2].any(), case


@pytest.mark.cuda
def test_softcap_prefill_kernel_matches_plain(card):
    """K3 with soft-capping: a row after cached pages, a fresh row and a
    kv_len = 0 row; windows none and 24; float32, bf16 and int8 pools."""
    for dtype in TOL:
        rng = np.random.default_rng(1)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        N, T, maxp = 3, 96, 6
        pages = rng.permutation(np.arange(1, P))
        pt = np.zeros((N, maxp), np.int32)
        pt[0, :6] = pages[:6]
        pt[1, :3] = pages[6:9]
        q_starts = np.array([64, 0, 0], np.int32)
        kv_lens = np.array([64 + 90, 81, 0], np.int32)
        q = (4 * t(rng.standard_normal((N, T, QH, D)).astype(np.float32))).to(io)
        for window in (None, 24):
            case = f"{dtype}, window {window}"
            a = (q, kp, vp, t(pt), t(q_starts), t(kv_lens), 1)
            out_k = ops.paged_prefill_attention_batch(*a, window=window, sm_scale=SM_SCALE,
                                                      logit_softcap=CAP, **kw)
            out_p = ops.paged_prefill_attention_batch_plain(
                *a, window=window, sm_scale=SM_SCALE, logit_softcap=CAP, **kw)
            uncapped = ops.paged_prefill_attention_batch_plain(
                *a, window=window, sm_scale=SM_SCALE, **kw)
            torch.cuda.synchronize()
            for n in range(N):
                live = max(int(kv_lens[n] - q_starts[n]), 0)
                if live:
                    assert _err(out_k[n, :live], out_p[n, :live]) <= TOL[dtype], case
            assert _err(uncapped[0], out_p[0]) > 10 * TOL[dtype], f"the cap matters ({case})"
            assert not out_k[2].any(), case


@pytest.mark.cuda
def test_hybrid_steps_kernels_match_plain(card):
    """The hybrid toy with the Gemma2 knobs at float32: a two-chunk prefill
    and a decode step through K1, K2 and K3 on the card, against the same
    steps through the plain versions; the soft-capped launches counted."""
    from kvcached_tpu_torch.models import hybrid as th

    cfg = th.HybridConfig.toy(dtype="float32", window=24, act="gelu_tanh", norm_offset=True,
                              embed_scale=True, post_norms=True, query_scale=16.0,
                              attn_softcap=2.0, final_softcap=0.5)
    params = th.init_hybrid_params(cfg, seed=0, device=card)
    G, lg = len(cfg.group_windows), cfg.layers_per_group
    g = torch.Generator(device=card).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (50,), generator=g, device=card, dtype=torch.int32)
    table = torch.arange(1, 2 * G * 2 + 1, dtype=torch.int32, device=card).reshape(G, 4)
    outs = []
    for reference in (False, True):
        ops.reset_launch_counts()
        shape = (lg, 2 * G * 2 + 1, cfg.num_kv_heads, TP, cfg.head_dim)
        kp, vp = torch.zeros(shape, device=card), torch.zeros(shape, device=card)
        for q0, n in ((0, 32), (32, 18)):
            toks = torch.zeros(32, dtype=torch.int32, device=card)
            toks[:n] = prompt[q0:q0 + n]
            pos = q0 + torch.arange(32, dtype=torch.int32, device=card)
            lg_p, _, _ = th.hybrid_prefill_step(params, cfg, toks, pos, kp, vp,
                                                table[:, q0 // TP: q0 // TP + 1].contiguous(),
                                                table, q0, n, reference_attention=reference)
        one = lambda x: torch.tensor([x], dtype=torch.int32, device=card)  # noqa: E731
        lg_d, _, _ = th.hybrid_decode_step(
            params, cfg, prompt[:1], one(50), kp, vp, table[:, None], table[:, 1:2].contiguous(),
            one(50 % TP), one(51), reference_attention=reference)
        torch.cuda.synchronize()
        outs.append((lg_p, lg_d[0]))
        counts = ops.launch_counts_by_dtype()
        if not reference:
            assert counts["K1"] == {"float32+softcap": cfg.num_layers}
            assert counts["K3"] == {"float32+softcap": 2 * cfg.num_layers}
            assert counts["K2"] == {"float32": 2 * cfg.num_layers}
    for a, b in zip(*outs):
        assert _err(a, b) <= 1e-4
