"""Soft-capped K4 (verify) and K1r (read-only decode) against their plain
PyTorch versions on the card, and the hybrid engine's speculative decoding
through the kernels against the plain path on the CPU.  These tests carry
the ``cuda`` marker and skip without a card (a CUDA kernel has no CPU
mode); on the H100 run
``python -m pytest --noconftest -m cuda tests/test_torch_hybrid_spec_cuda.py``.

The queries are scaled so that the scores reach several times the cap, and
each case checks that the uncapped output lies far outside the tolerance.
Windows: none, 4096 (Gemma2's, past every context here) and 1024 (cutting
the longest row).  Tolerances: pool writes bit-exact; outputs within 1e-4
at float32 (TF32 off) and 2e-2 at bfloat16 and on int8 and e4m3 pools
(bf16 operands, one bf16 ulp of a unit-scale output is ~8e-3); the engine's
greedy tokens identical.  This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from kvcached_tpu_torch import ops

L, P, KH, QH, TP, D = 2, 112, 2, 4, 32, 128
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 2e-2,
       torch.float8_e4m3fn: 2e-2}
CAP, SM_SCALE = 5.0, 144 ** -0.5
WINDOWS = (None, 4096, 1024)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rng, dtype, dev):
    """Pools of ``dtype`` (page 0 zero; int8 with per-head scales, e4m3 of
    N(0, 1)), the type q and new K/V come in, and the int8 scale keywords."""
    from kvcached_tpu_torch.ops import quantize_kv

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    scales = [t((0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)) for _ in range(2)]
    pools = []
    for sc in scales:
        x = t(rng.standard_normal((L, P, KH, TP, D)).astype(np.float32))
        x = quantize_kv(x, dtype, sc[:, None, :, None, None])
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
        for j in range(min(-(-int(s) // TP), maxp)):
            pt[b, j] = next(pages)
    return pt


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_softcap_verify_kernel_matches_plain(card):
    """K4 with soft-capping, T = 5: a long row, a row overhanging its table
    by 2 (those slots discarded), a row whose writes are all discarded and
    a short row; every pool type."""
    T, maxp = 5, 48
    for dtype in TOL:
        rng = np.random.default_rng(0)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        seq_lens = np.array([1500, maxp * TP + 2, 300, 9], np.int32)
        pt = _table(rng, seq_lens, maxp)
        pos = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
        inside = pos < maxp * TP
        slot_pages = np.where(inside, np.take_along_axis(pt, np.minimum(pos // TP, maxp - 1), 1), 0)
        slot_pages[2] = 0
        q = (4 * t(rng.standard_normal((4, T, QH, D)).astype(np.float32))).to(io)
        kn = t(rng.standard_normal((4, T, KH, D)).astype(np.float32)).to(io)
        vn = t(rng.standard_normal((4, T, KH, D)).astype(np.float32)).to(io)
        args = (t(pt), t(seq_lens), 1, kn, vn, t(slot_pages.astype(np.int32)),
                t((pos % TP).astype(np.int32)))
        live = t(inside)
        for window in WINDOWS:
            case = f"{dtype}, window {window}"
            kp2, vp2 = kp.clone(), vp.clone()
            before = ops.paged_attention_verify.launches_by_dtype.copy()
            out_k, _, _ = ops.paged_attention_verify(q, kp, vp, *args, window=window,
                                                     sm_scale=SM_SCALE, logit_softcap=CAP, **kw)
            out_p, _, _ = ops.paged_attention_verify_plain(
                q, kp2, vp2, *args, window=window, sm_scale=SM_SCALE, logit_softcap=CAP, **kw)
            uncapped = ops.paged_attention_verify_plain(
                q, kp2.clone(), vp2.clone(), *args, window=window, sm_scale=SM_SCALE, **kw)[0]
            torch.cuda.synchronize()
            key = str(dtype).replace("torch.", "") + "+softcap"
            assert ops.paged_attention_verify.launches_by_dtype[key] == before.get(key, 0) + 1
            assert _same(kp, kp2) and _same(vp, vp2), case
            assert _err(out_k[live], out_p[live]) <= TOL[dtype], case
            assert _err(uncapped[live], out_p[live]) > 10 * TOL[dtype], f"the cap matters ({case})"


@pytest.mark.cuda
def test_softcap_readonly_kernel_matches_plain(card):
    """K1r with soft-capping: a long row, a short row and a zero-length
    row; every pool type."""
    for dtype in TOL:
        rng = np.random.default_rng(1)
        (kp, vp), io, kw, t = _inputs(rng, dtype, card)
        seq_lens = np.array([1500, 70, 0], np.int32)
        pt = _table(rng, seq_lens, 48)
        q = (4 * t(rng.standard_normal((3, QH, D)).astype(np.float32))).to(io)
        a = (q, kp, vp, t(pt), t(seq_lens), 1)
        for window in WINDOWS:
            case = f"{dtype}, window {window}"
            out_k = ops.paged_attention(*a, window=window, sm_scale=SM_SCALE,
                                        logit_softcap=CAP, **kw)
            out_p = ops.paged_attention_decode_plain(
                *a, None, None, None, None, window=window, sm_scale=SM_SCALE, write_kv=False,
                logit_softcap=CAP, **kw)[0]
            uncapped = ops.paged_attention_decode_plain(
                *a, None, None, None, None, window=window, sm_scale=SM_SCALE, write_kv=False,
                **kw)[0]
            torch.cuda.synchronize()
            assert _err(out_k, out_p) <= TOL[dtype], case
            assert _err(uncapped, out_p) > 10 * TOL[dtype], f"the cap matters ({case})"
            assert not out_k[2].any(), case


@pytest.mark.cuda
def test_hybrid_spec_engine_kernels_match_plain(card):
    """The hybrid toy with the Gemma2 knobs at float32, served with spec
    decode (spec_exact) through the kernels on the card and through the
    plain versions on the CPU: identical greedy tokens, soft-capped K4
    launched; and on an int8 arena on the card, spec decode equal to plain
    decode, with K4's int8 soft-capped mode launched."""
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
    from kvcached_tpu_torch.models import hybrid as th

    cfg = th.HybridConfig.toy(dtype="float32", act="gelu_tanh", norm_offset=True,
                              embed_scale=True, post_norms=True, query_scale=64.0,
                              attn_softcap=5.0, final_softcap=8.0)
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)] for n in (5, 12, 30, 40)]
    prompts.append(([3, 1, 4, 1, 5, 9, 2, 6] * 6)[:40])  # repetitive: drafts accepted
    ec = dict(max_batch=5, max_model_len=96, page_tokens=32, decode_horizon=4,
              prefill_buckets=(32,), num_pages=40, prefill_batch=4)

    def serve(dev, **kw):
        params = th.init_hybrid_params(cfg, seed=0, device="cpu").to(dev)
        eng = LLMEngine(cfg, EngineConfig(**{**ec, **kw}), params=params, device=dev)
        try:
            ops.reset_launch_counts()
            out = [o.output_tokens for o in eng.generate(prompts, SamplingParams(max_new_tokens=24))]
            return out, ops.launch_counts_by_dtype(), eng.kv_metrics().get("spec")
        finally:
            eng.shutdown()

    spec = dict(spec_decode=True, spec_exact=True, kv_dtype="float32")
    got, counts, m = serve(card, **spec)
    want, _, _ = serve(torch.device("cpu"), **spec)
    assert got == want
    assert m["dispatches"] > 0 and counts["K4"].get("float32+softcap", 0) > 0, (m, counts)
    plain8, _, _ = serve(card, kv_dtype="int8")
    spec8, counts8, _ = serve(card, kv_dtype="int8", spec_decode=True)
    assert spec8 == plain8
    assert counts8["K4"].get("int8+softcap", 0) > 0, counts8
