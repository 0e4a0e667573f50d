"""Logit soft-capping in the plain versions of K1 and K3 against the JAX
package's Pallas kernels run with ``interpret=True``, on the same numpy
inputs, and the soft-capping contract of the kernel wrappers.

The queries are scaled so that the scores reach several times the cap
(capped and uncapped outputs differ by far more than the tolerance, which
the test asserts).  K1 runs on a float32 pool with a window, a discarded
slot and a zero-length row, and on an int8 pool with per-head scales; K3 on
a float32 pool with a window, a row after a cached page and a kv_len = 0
row.  The JAX calls compile as one program at XLA's lowest optimisation
level, the kernels copying one page a DMA chunk.  The file holds two tests:
the port's files run last in Tier-1 (loadfile queues files by their count
of collected items), and the new ones should not push older ones out.

Tolerances: written pools are equal element by element (bytes for int8);
outputs agree within atol 1e-5 (both sides compute in float32, in
different summation orders; the int8 case rounds q and the softmax weights
to bf16 operands at the same places on both sides).

The CUDA kernels run only on the card: tests/test_torch_hybrid_cuda.py
holds them against these plain versions there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.ops.paged_attention import paged_attention_decode as j_decode
from kvcached_tpu.ops.paged_prefill import paged_prefill_attention_batch as j_prefill
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, KH, QH, TP, D = 2, 12, 2, 4, 32, 128
CAP = 5.0  # scores reach ~4x the cap: q scaled by 4, sm_scale 1/12 (Gemma2's)
SM_SCALE = 144 ** -0.5


def _t(x):
    return torch.from_numpy(np.array(x))


def _decode_case(rng, int8):
    """K1 inputs on one-page tables: row 0 a full page cut by the window,
    row 1 a slot on the zero page (write discarded), row 2 zero length,
    row 3 short."""
    ks = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    vs = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    pools = []
    for sc in (ks, vs):
        x = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
        if int8:
            x = np.clip(np.round(x / sc[:, None, :, None, None]), -127, 127).astype(np.int8)
        x[:, 0] = 0
        pools.append(x)
    seq_lens = np.array([32, 27, 0, 9], np.int32)
    page_tables = np.array([[3], [2], [0], [7]], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages = page_tables[np.arange(4), pos // TP].astype(np.int32)
    slot_pages[1] = slot_pages[2] = 0
    slot_offsets = (pos % TP).astype(np.int32)
    q = 4 * rng.standard_normal((4, QH, D)).astype(np.float32)
    kn = rng.standard_normal((4, KH, D)).astype(np.float32)
    vn = rng.standard_normal((4, KH, D)).astype(np.float32)
    return [q, *pools, page_tables, seq_lens, kn, vn, slot_pages, slot_offsets, ks, vs]


def _prefill_case(rng):
    """K3 inputs: a row after a cached page (q_start > 0), a fresh row and
    a kv_len = 0 row."""
    kp = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    vp = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    kp[:, 0] = vp[:, 0] = 0
    page_tables = np.array([[4, 9], [6, 0], [0, 0]], np.int32)
    q_starts = np.array([32, 0, 0], np.int32)
    kv_lens = np.array([32 + 27, 30, 0], np.int32)
    q = 4 * rng.standard_normal((3, 32, QH, D)).astype(np.float32)
    return [q, kp, vp, page_tables, q_starts, kv_lens]


def test_softcap_plain_matches_jax():
    """K1 with soft-capping on a float32 pool with a window and on an int8
    pool, and K3 with soft-capping and a window on a float32 pool, all in
    one JAX program; the uncapped outputs lie far from the capped ones."""
    rng = np.random.default_rng(0)
    decodes = [(_decode_case(rng, False), 20, False), (_decode_case(rng, True), None, True)]
    prefill, p_window = _prefill_case(rng), 24

    def run(*arrays):
        outs = []
        for i, (_, w, int8) in enumerate(decodes):
            q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = arrays[11 * i: 11 * i + 11]
            sc = dict(k_scales=ks, v_scales=vs) if int8 else {}
            outs.append(j_decode(q, kp, vp, pt, sl, 1, kn, vn, sp, so, interpret=True,
                                 window=w, sm_scale=SM_SCALE, logit_softcap=CAP, **sc))
        outs.append(j_prefill(*arrays[22:], 1, interpret=True, window=p_window,
                              sm_scale=SM_SCALE, logit_softcap=CAP))
        return outs

    got_j = jax_lowest(run, *[jnp.asarray(a) for c, _, _ in decodes for a in c],
                       *map(jnp.asarray, prefill))
    for (case, w, int8), (out_j, kp_j, vp_j) in zip(decodes, got_j):
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, case)
        sc = dict(k_scales=ks, v_scales=vs) if int8 else {}
        out_t, kp_t, vp_t = ops.paged_attention_decode(
            q, kp, vp, pt, sl, 1, kn, vn, sp, so, window=w, sm_scale=SM_SCALE,
            logit_softcap=CAP, **sc)
        np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
        np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
        assert not out_t[2].any(), "a zero-length row gives zeros"
        uncapped = ops.paged_attention_decode_plain(
            q, kp_t.clone(), vp_t.clone(), pt, sl, 1, kn, vn, sp, so, window=w,
            sm_scale=SM_SCALE, **sc)[0]
        assert (uncapped - out_t).abs().max().item() > 1000 * ATOL

    out_j = np.asarray(got_j[-1])
    targs = [_t(a) for a in prefill]
    out_t = ops.paged_prefill_attention_batch(
        *targs, 1, window=p_window, sm_scale=SM_SCALE, logit_softcap=CAP).numpy()
    q_starts, kv_lens = prefill[4], prefill[5]
    for n in range(len(q_starts)):
        live = max(int(kv_lens[n] - q_starts[n]), 0)  # padding query rows are discarded
        np.testing.assert_allclose(out_t[n, :live], out_j[n, :live], atol=ATOL, rtol=0)
    assert not out_t[2].any(), "a kv_len=0 row gives zeros"
    uncapped = ops.paged_prefill_attention_batch(*targs, 1, window=p_window,
                                                 sm_scale=SM_SCALE).numpy()
    assert np.abs(uncapped - out_t).max() > 1000 * ATOL


def test_softcap_wrapper_contract(monkeypatch):
    """On CPU tensors K1, K1r, K3 and K4 run their plain versions with the
    cap and count no launch; the MLA modes refuse a cap (not ported yet); a
    CUDA tensor (stubbed: no card here) launches or raises, never the plain
    version."""
    rng = np.random.default_rng(2)
    q, kp, vp, pt, sl, kn, vn, sp, so, _, _ = map(_t, _decode_case(rng, False))
    counts = ops.launch_counts()
    out, _, _ = ops.paged_attention_decode(q, kp, vp, pt, sl, 0, kn, vn, sp, so,
                                           logit_softcap=CAP)
    want = ops.paged_attention_decode_plain(q, kp, vp, pt, sl, 0, kn, vn, sp, so,
                                            logit_softcap=CAP)[0]
    assert torch.equal(out, want)
    qp = q[None].expand(1, 4, QH, D).contiguous()
    qs, kl = torch.tensor([0], dtype=torch.int32), torch.tensor([4], dtype=torch.int32)
    out = ops.paged_prefill_attention(qp[0], kp, vp, pt[0], 0, 4, 0, logit_softcap=CAP)
    want = ops.paged_prefill_attention_batch_plain(qp, kp, vp, pt[:1], qs, kl, 0,
                                                   logit_softcap=CAP)[0]
    assert torch.equal(out, want)
    out = ops.paged_attention(q, kp, vp, pt, sl, 0, logit_softcap=CAP)
    want = ops.paged_attention_decode_plain(q, kp, vp, pt, sl, 0, None, None, None, None,
                                            write_kv=False, logit_softcap=CAP)[0]
    assert torch.equal(out, want)
    fed = (q[:, None], kp, vp, pt, sl, 0, kn[:, None], vn[:, None], sp[:, None], so[:, None])
    out = ops.paged_attention_verify(*fed, logit_softcap=CAP)[0]
    want = ops.paged_attention_verify_plain(*fed, logit_softcap=CAP)[0]
    assert torch.equal(out, want)
    assert ops.launch_counts() == counts, "the plain path counts no launch"
    with pytest.raises(ValueError):
        ops.paged_attention_decode(q, kp, vp, pt, sl, 0, kn, vn, sp, so, logit_softcap=0.0)
    with pytest.raises(ValueError):
        ops.paged_attention_verify(*fed, logit_softcap=-1.0)
    with pytest.raises(NotImplementedError):
        ops.paged_attention_decode(q, kp[:, :, :1], None, pt, sl, 0, kn[:, :1], None, sp,
                                   so, mla_v_dim=64, logit_softcap=CAP)
    with pytest.raises(NotImplementedError):
        ops.paged_attention_verify(q[:, None], kp[:, :, :1], None, pt, sl, 0, kn[:, None, :1],
                                   None, sp[:, None], so[:, None], mla_v_dim=64,
                                   logit_softcap=CAP)

    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")
    pp = importlib.import_module("kvcached_tpu_torch.ops.paged_prefill")

    def no_build(name):
        raise RuntimeError("build refused")

    monkeypatch.setattr(importlib.import_module("kvcached_tpu_torch.ops._build"), "load",
                        no_build)
    for mod in (pa, pp):
        monkeypatch.setattr(mod, "_on_cpu", lambda *ts: False)
    ran = []
    for mod, name in ((pa, "paged_attention_decode_plain"), (pa, "paged_attention_verify_plain"),
                      (pp, "paged_prefill_attention_batch_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="build refused"):
        pa.paged_attention_decode(q, kp, vp, pt, sl, 0, kn, vn, sp, so, logit_softcap=CAP)
    with pytest.raises(RuntimeError, match="build refused"):
        pa.paged_attention(q, kp, vp, pt, sl, 0, logit_softcap=CAP)
    with pytest.raises(RuntimeError, match="build refused"):
        pa.paged_attention_verify(*fed, logit_softcap=CAP)
    with pytest.raises(RuntimeError, match="build refused"):
        pp.paged_prefill_attention_batch(qp, kp, vp, pt[:1], qs, kl, 0, logit_softcap=CAP)
    assert not ran, "the plain versions never ran"
    assert ops.launch_counts() == counts, "a launch that failed is not counted"
