"""The head_dim 256 instances of K1, K1r, K2, K3 and K4 against their plain
PyTorch versions on the card, on float32, bf16, int8 and e4m3 pools,
soft-capped and not, and a head_dim 256 hybrid model's steps through the
kernels against their plain path.  These tests carry the ``cuda`` marker
and skip without a card (a CUDA kernel has no CPU mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_hd256_cuda.py``.

Gemma2's group of 2 (QH 4, KH 2) and one group of 16 (K1's widest, whose
warps merge in two rounds at 256).  Windows: none, 4096 (Gemma2's, past
every context here) and one that cuts the longest row.  The capped cases
scale q so that the scores reach several times the cap, and check that the
uncapped output lies far outside the tolerance.  Tolerances: pool writes
bit-exact (K2 also writes the reference's int8 and e4m3 edge values);
outputs within 1e-4 at float32 (TF32 off) and 2e-2 at bfloat16 and on int8
and e4m3 pools (bf16 operands: one bf16 ulp of a unit-scale output is
~8e-3); the toy model's last-position logits within 1e-4 at float32.  Each
launch is counted under its pool type with ``+d256``.  This file imports
nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, KH, QH, TP, D = 2, 112, 2, 4, 32, 256
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2,
       torch.float8_e4m3fn: 2e-2}
CAP, SM_SCALE = 5.0, 256 ** -0.5
WINDOWS = (None, 4096, 100)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rng, dtype, dev, kh=KH):
    """Pools of ``dtype`` (page 0 zero; int8 with per-head scales, e4m3 of
    N(0, 1)), the type q and new K/V come in, and the int8 scale keywords."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    scales = [t((0.02 + 0.03 * rng.random((L, kh))).astype(np.float32)) for _ in range(2)]
    pools = []
    for sc in scales:
        x = t(rng.standard_normal((L, P, kh, TP, D)).astype(np.float32))
        x = ops.quantize_kv(x, dtype, sc[:, None, :, None, None])
        x[:, 0] = 0
        pools.append(x)
    kw = dict(k_scales=scales[0], v_scales=scales[1]) if dtype == torch.int8 else {}
    io = torch.bfloat16 if dtype in (torch.int8, torch.float8_e4m3fn) else dtype
    return pools, io, kw, t


def _table(rng, seq_lens, maxp):
    """Page tables of distinct shuffled pages, each row's first pages."""
    pages = iter(rng.permutation(np.arange(1, P)))
    pt = np.zeros((len(seq_lens), maxp), np.int32)
    for b, s in enumerate(seq_lens):
        for i in range(-(-int(s) // TP)):
            pt[b, i] = next(pages)
    return pt


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _same(a, b):
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def _key(dtype, cap):
    return str(dtype).replace("torch.", "") + ("+softcap" if cap else "") + "+d256"


@pytest.mark.cuda
def test_hd256_decode_kernels_match_plain(card):
    """K1 (write + attend) and K1r (read-only): a long row, a discarded
    write, a zero-length row and a short row, on every pool type, capped
    and not, at Gemma2's group of 2 and at a group of 16."""
    for dtype in TOL:
        for qh in (QH, 16 * KH):
            rng = np.random.default_rng(0)
            (kp, vp), io, kw, t = _inputs(rng, dtype, card)
            B, maxp = 4, 8
            seq_lens = np.array([250, 70, 0, 9], np.int32)
            pt = _table(rng, seq_lens, maxp)
            pos = np.maximum(seq_lens - 1, 0)
            slot_pages = pt[np.arange(B), pos // TP].copy()
            slot_pages[1:3] = 0
            q0 = t(rng.standard_normal((B, qh, D)).astype(np.float32))
            kn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(io)
            vn = t(rng.standard_normal((B, KH, D)).astype(np.float32)).to(io)
            args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages),
                    t((pos % TP).astype(np.int32)))
            for cap in (None, CAP):
                q = (q0 * (4 if cap else 1)).to(io)
                for window in WINDOWS:
                    case = f"{dtype}, G={qh // KH}, cap {cap}, window {window}"
                    kp2, vp2 = kp.clone(), vp.clone()
                    before = ops.paged_attention_decode.launches_by_dtype.get(_key(dtype, cap), 0)
                    out_k, _, _ = ops.paged_attention_decode(
                        q, kp, vp, *args, window=window, sm_scale=SM_SCALE,
                        logit_softcap=cap, **kw)
                    out_p, _, _ = ops.paged_attention_decode_plain(
                        q, kp2, vp2, *args, window=window, sm_scale=SM_SCALE,
                        logit_softcap=cap, **kw)
                    ro_k = ops.paged_attention(q, kp, vp, *args[:2], 0, window=window,
                                               sm_scale=SM_SCALE, logit_softcap=cap, **kw)
                    ro_p = ops.paged_attention_decode_plain(
                        q, kp, vp, *args[:2], 0, None, None, None, None, window=window,
                        sm_scale=SM_SCALE, write_kv=False, logit_softcap=cap, **kw)[0]
                    torch.cuda.synchronize()
                    assert ops.paged_attention_decode.launches_by_dtype[_key(dtype, cap)] \
                        == before + 1, case
                    assert _same(kp, kp2) and _same(vp, vp2), case
                    assert _err(out_k, out_p) <= TOL[dtype], case
                    assert _err(ro_k, ro_p) <= TOL[dtype], case
                    assert not out_k[2].any() and not ro_k[2].any(), case
                    if cap:
                        uncapped = ops.paged_attention_decode_plain(
                            q, kp, vp, *args[:2], 0, None, None, None, None, window=window,
                            sm_scale=SM_SCALE, write_kv=False, **kw)[0]
                        assert _err(uncapped, ro_p) > 10 * TOL[dtype], f"the cap ({case})"


@pytest.mark.cuda
def test_hd256_prefill_write_and_attend_match_plain(card):
    """K2 writes bit-exactly (the reference's int8 and e4m3 edge values
    too) and K3 attends a row after cached pages, a fresh row and a kv_len
    = 0 row, on every pool type, capped and not."""
    for dtype in TOL:
        rng = np.random.default_rng(1)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        # K2: a 4-page chunk, one page of it discarded
        T2 = 4 * TP
        kn = t(rng.standard_normal((KH, T2, D)).astype(np.float32)).to(io)
        vn = t(rng.standard_normal((KH, T2, D)).astype(np.float32)).to(io)
        wkw = {}
        if dtype == torch.int8:
            wkw = dict(k_scale=kw["k_scales"][1].clone(), v_scale=kw["v_scales"][1])
            wkw["k_scale"][0] = 0.5
            kn[0, 0, :6] = torch.tensor([0.25, 0.75, 1.25, -0.25, -0.75, 100.0])
        elif dtype == torch.float8_e4m3fn:
            kn[0, 0, :6] = torch.tensor([460.0, 464.0, 470.0, -500.0, float("inf"), 1e-9])
        pages = t(np.array([5, 0, 9, 11], np.int32))
        kp2, vp2 = kp.clone(), vp.clone()
        ops.write_prefill_kv(kp, vp, kn, vn, pages, 1, **wkw)
        ops.write_prefill_kv_plain(kp2, vp2, kn, vn, pages, 1, **wkw)
        torch.cuda.synchronize()
        assert _same(kp, kp2) and _same(vp, vp2), dtype
        assert ops.write_prefill_kv.launches_by_dtype[_key(dtype, None)] >= 1
        if dtype in (torch.int8, torch.float8_e4m3fn):
            edge = kp[1, 5, 0, 0, :6].view(torch.uint8).tolist()
            want = ([0, 2, 2, 0, 0xFE, 0x7F] if dtype == torch.int8
                    else [0x7E, 0x7E, 0x7F, 0xFF, 0x7F, 0x00])
            assert edge == want, dtype
        # K3
        N, T, maxp = 3, 96, 8
        before = ops.paged_prefill_attention_batch.launches_by_dtype.get(_key(dtype, CAP), 0)
        q_starts = np.array([128, 0, 0], np.int32)
        kv_lens = np.array([128 + 90, 81, 0], np.int32)
        pt = _table(rng, np.array([218, 81, 0]), maxp)
        q0 = t(rng.standard_normal((N, T, QH, D)).astype(np.float32))
        for cap in (None, CAP):
            q = (q0 * (4 if cap else 1)).to(io)
            for window in WINDOWS:
                case = f"{dtype}, cap {cap}, window {window}"
                a = (q, kp, vp, t(pt), t(q_starts), t(kv_lens), 1)
                out_k = ops.paged_prefill_attention_batch(*a, window=window, sm_scale=SM_SCALE,
                                                          logit_softcap=cap, **kw)
                out_p = ops.paged_prefill_attention_batch_plain(
                    *a, window=window, sm_scale=SM_SCALE, logit_softcap=cap, **kw)
                torch.cuda.synchronize()
                for n in range(N):
                    live = max(int(kv_lens[n] - q_starts[n]), 0)
                    if live:
                        assert _err(out_k[n, :live], out_p[n, :live]) <= TOL[dtype], case
                assert not out_k[2].any(), case
                if cap:
                    uncapped = ops.paged_prefill_attention_batch_plain(
                        *a, window=window, sm_scale=SM_SCALE, **kw)
                    assert _err(uncapped[0], out_p[0]) > 10 * TOL[dtype], f"the cap ({case})"
        assert ops.paged_prefill_attention_batch.launches_by_dtype[_key(dtype, CAP)] \
            == before + len(WINDOWS)


@pytest.mark.cuda
def test_hd256_verify_kernel_matches_plain(card):
    """K4: T=5 fed tokens a row (a row overhanging its table, a row whose
    writes are all discarded) on every pool type, capped and not, and T*G
    = 64 query rows, K4's limit at 256 as at 128; more raise."""
    for dtype in TOL:
        rng = np.random.default_rng(2)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        for T in (5, 32):
            B, maxp = 4, 12
            width = maxp * TP
            seq_lens = np.array([width + 2, 300, 77, T + 3], np.int32)
            pt = _table(rng, np.minimum(seq_lens, width), maxp)
            pos = seq_lens[:, None] - T + np.arange(T)[None]
            inside = pos < width
            slot_pages = np.where(inside, pt[np.arange(B)[:, None],
                                            np.minimum(pos, width - 1) // TP], 0)
            slot_pages[2] = 0
            slot_pages = slot_pages.astype(np.int32)
            q0 = t(rng.standard_normal((B, T, QH, D)).astype(np.float32))
            kn = t(rng.standard_normal((B, T, KH, D)).astype(np.float32)).to(io)
            vn = t(rng.standard_normal((B, T, KH, D)).astype(np.float32)).to(io)
            args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages),
                    t((pos % TP).astype(np.int32)))
            live = t(inside)
            for cap in ((None, CAP) if T == 5 else (CAP,)):
                q = (q0 * (4 if cap else 1)).to(io)
                for window in WINDOWS:
                    case = f"{dtype}, T={T}, cap {cap}, window {window}"
                    kp2, vp2 = kp.clone(), vp.clone()
                    out_k, _, _ = ops.paged_attention_verify(
                        q, kp, vp, *args, window=window, sm_scale=SM_SCALE,
                        logit_softcap=cap, **kw)
                    out_p, _, _ = ops.paged_attention_verify_plain(
                        q, kp2, vp2, *args, window=window, sm_scale=SM_SCALE,
                        logit_softcap=cap, **kw)
                    torch.cuda.synchronize()
                    assert _same(kp, kp2) and _same(vp, vp2), case
                    assert _err(out_k[live], out_p[live]) <= TOL[dtype], case
                    if cap:
                        uncapped = ops.paged_attention_verify_plain(
                            q, kp2.clone(), vp2.clone(), *args, window=window,
                            sm_scale=SM_SCALE, **kw)[0]
                        assert _err(uncapped[live], out_p[live]) > 10 * TOL[dtype], \
                            f"the cap ({case})"
        assert ops.paged_attention_verify.launches_by_dtype[_key(dtype, CAP)] >= 2 * len(WINDOWS)
        with pytest.raises(ValueError, match="query rows"):
            ops.paged_attention_verify(
                torch.zeros((1, 33, QH, D), dtype=io, device=card), kp, vp,
                t(np.zeros((1, 2), np.int32)), t(np.array([40], np.int32)), 0,
                torch.zeros((1, 33, KH, D), dtype=io, device=card),
                torch.zeros((1, 33, KH, D), dtype=io, device=card),
                t(np.zeros((1, 33), np.int32)), t(np.zeros((1, 33), np.int32)), **kw)


@pytest.mark.cuda
def test_hd256_hybrid_steps_kernels_match_plain(card):
    """A two-layer Gemma2-shaped toy at head_dim 256 with hidden != heads x
    head_dim, float32: a two-chunk prefill, a decode step and a verify step
    through K1, K2, K3 and K4 on the card against the same steps through
    the plain versions; the head_dim 256 launches counted."""
    from kvcached_tpu_torch.models import hybrid as th

    cfg = th.HybridConfig.toy(num_layers=2, dtype="float32", window=24, hidden_size=384,
                              head_dim=256, act="gelu_tanh", norm_offset=True,
                              embed_scale=True, post_norms=True, query_scale=256.0,
                              attn_softcap=2.0, final_softcap=0.5)
    params = th.init_hybrid_params(cfg, seed=0, device=card)
    G, lg = len(cfg.group_windows), cfg.layers_per_group
    g = torch.Generator(device=card).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (50,), generator=g, device=card, dtype=torch.int32)
    table = torch.arange(1, 2 * G * 2 + 1, dtype=torch.int32, device=card).reshape(G, 4)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=card)  # noqa: E731
    Tv = 5
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
        lg_d, _, _ = th.hybrid_decode_step(
            params, cfg, prompt[:1], one(50), kp, vp, table[:, None], table[:, 1:2].contiguous(),
            one(50 % TP), one(51), reference_attention=reference)
        vpos = 51 + torch.arange(Tv, dtype=torch.int32, device=card)
        lg_v, _, _ = th.hybrid_verify_step(
            params, cfg, prompt[None, 1:Tv + 1], vpos[None], kp, vp, table[:, None],
            table[:, vpos // TP][:, None].contiguous(), (vpos % TP)[None], one(51 + Tv),
            reference_attention=reference)
        torch.cuda.synchronize()
        outs.append((lg_p, lg_d[0], lg_v[0]))
        counts = ops.launch_counts_by_dtype()
        if not reference:
            assert counts["K1"] == {"float32+softcap+d256": cfg.num_layers}
            assert counts["K3"] == {"float32+softcap+d256": 2 * cfg.num_layers}
            assert counts["K2"] == {"float32+d256": 2 * cfg.num_layers}
            assert counts["K4"] == {"float32+softcap+d256": cfg.num_layers}
    for a, b in zip(*outs):
        assert _err(a, b) <= 1e-4
