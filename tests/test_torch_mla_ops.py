"""The plain versions of the port's MLA kernels (K5 decode and verify, K6,
K3m) against the JAX package's Pallas kernels in their MLA mode, on the
same numpy inputs (float32, ``MLAConfig.toy`` widths: one latent kv head of
256 lanes, values its first 128, 4 query heads, 16-token pages); the MLA
wrappers' contract on the CPU.

The JAX kernels run with one page a DMA chunk (``pages_per_chunk=1``, a
tiling choice that leaves the function unchanged): interpret mode compiles
the chunk loop unrolled, and one page a chunk keeps each call near 0.7 s.

Tolerances: pool writes are copies, so the pools must be equal element by
element; attention outputs agree within atol 1e-5 over the live queries
(both sides compute in float32, in different summation orders), lanes past
the values included (zero on both sides).  A decode row of length 0 and
verify queries outside ``[0, table width)`` are not live: the engine
discards them.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
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

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, QH, TP, D, R = 2, 24, 4, 16, 256, 128
SCALE = 1.0 / np.sqrt(128.0)  # the toy's 1 / sqrt(qk_nope + qk_rope)
#: the V pool the JAX package's MLA mode ignores (kvcached_tpu/models/mla.py
#: passes the same placeholder)
DUMMY_V = jnp.zeros((1, 1, 1, 1, 128), jnp.float32)


def _pool(rng, num_pages=P):
    k = rng.standard_normal((L, num_pages, 1, TP, D)).astype(np.float32)
    k[:, 0] = 0.0  # the zero page
    return k


def _t(x):
    return torch.from_numpy(np.array(x))


def _tables(rng, seq_lens, maxp):
    pages = rng.permutation(np.arange(1, P))
    pt = np.zeros((len(seq_lens), maxp), np.int32)
    for b, s in enumerate(seq_lens):
        n = min(-(-int(s) // TP), maxp)
        pt[b, :n] = pages[b * maxp: b * maxp + n]
    return pt


def _slots(page_tables, positions):
    """Slot (page, offset) of each fed token; positions past the table go
    to the zero page, as the engine routes them."""
    maxp = page_tables.shape[1]
    inside = positions < maxp * TP
    idx = np.minimum(positions, maxp * TP - 1) // TP
    pages = np.where(inside, np.take_along_axis(page_tables, idx, -1), 0)
    return pages.astype(np.int32), (positions % TP).astype(np.int32)


def test_decode_plain_matches_jax():
    """K5, decode form: rows of 60 and 33 tokens, one whose write is
    discarded, a padding row of length 0 and a one-token row."""
    rng = np.random.default_rng(0)
    kp = _pool(rng)
    seq_lens = np.array([60, 33, 0, 1], np.int32)
    pt = _tables(rng, seq_lens, 4)
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages, slot_offsets = _slots(pt, pos[:, None])
    slot_pages = slot_pages[:, 0].copy()
    slot_pages[1:3] = 0
    q = rng.standard_normal((4, QH, D)).astype(np.float32)
    ent = rng.standard_normal((4, 1, D)).astype(np.float32)
    out_j, kp_j, vp_j = j_decode(
        *map(jnp.asarray, (q, kp)), DUMMY_V, *map(jnp.asarray, (pt, seq_lens)), 1,
        *map(jnp.asarray, (ent, ent, slot_pages, slot_offsets[:, 0])),
        sm_scale=SCALE, mla_v_dim=R, interpret=True, pages_per_chunk=1)
    assert vp_j is None
    tk = _t(kp)
    out_t, kp_t, vp_t = ops.paged_attention_decode(
        _t(q), tk, None, _t(pt), _t(seq_lens), 1, _t(ent), None, _t(slot_pages),
        _t(slot_offsets[:, 0]), sm_scale=SCALE, mla_v_dim=R)
    assert vp_t is None and kp_t.data_ptr() == tk.data_ptr(), "one pool, updated in place"
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    live = seq_lens > 0
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live], atol=ATOL, rtol=0)
    assert not out_t[2].any() and not out_t[..., R:].any()


def test_verify_plain_matches_jax():
    """K5, verify form at T=4: a long row, a row with a discarded slot, a
    row overhanging its table by 2 < T, a padding row and a short row."""
    rng = np.random.default_rng(1)
    kp = _pool(rng)
    T, maxp = 4, 4
    seq_lens = np.array([60, 50, maxp * TP + 2, 0, 7], np.int32)
    pt = _tables(rng, seq_lens, maxp)
    positions = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
    slot_pages, slot_offsets = _slots(pt, positions)
    slot_pages[1, 1] = 0
    slot_pages[3] = 0
    q = rng.standard_normal((5, T, QH, D)).astype(np.float32)
    ent = rng.standard_normal((5, T, 1, D)).astype(np.float32)
    out_j, kp_j, _ = j_verify(
        *map(jnp.asarray, (q, kp)), DUMMY_V, *map(jnp.asarray, (pt, seq_lens)), 1,
        *map(jnp.asarray, (ent, ent, slot_pages, slot_offsets)),
        sm_scale=SCALE, mla_v_dim=R, interpret=True, pages_per_chunk=1)
    out_t, kp_t, vp_t = ops.paged_attention_verify(
        _t(q), _t(kp), None, _t(pt), _t(seq_lens), 1, _t(ent), None, _t(slot_pages),
        _t(slot_offsets), sm_scale=SCALE, mla_v_dim=R)
    assert vp_t is None
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    qpos = seq_lens[:, None] - T + np.arange(T)[None]
    live = (qpos >= 0) & (qpos < maxp * TP)
    assert live.sum() == 14 and not live[3].any()
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live], atol=ATOL, rtol=0)
    assert not out_t[3].any() and not out_t[..., R:].any()


def test_prefill_write_and_attend_match_jax():
    """K6 writes a 3-page latent chunk with its middle page discarded; K3m
    attends a batch of a cached-prefix row (q_start > 0), a fresh row and a
    kv_len = 0 padding row."""
    rng = np.random.default_rng(2)
    kp = _pool(rng)
    T = 48
    ent = rng.standard_normal((1, T, D)).astype(np.float32)
    pages = np.array([5, 0, 9], np.int32)
    kp_j = np.asarray(j_write_single(jnp.asarray(kp), jnp.asarray(ent), jnp.asarray(pages), 1,
                                     interpret=True))
    kp_t = ops.write_prefill_kv_single(_t(kp), _t(ent), _t(pages), 1)
    np.testing.assert_array_equal(kp_t.numpy(), kp_j)

    N, Tq, maxp = 3, 32, 6
    pt = _tables(rng, [96, 20, 0], maxp)
    q_starts = np.array([64, 0, 0], np.int32)
    kv_lens = np.array([64 + 30, 20, 0], np.int32)
    q = rng.standard_normal((N, Tq, QH, D)).astype(np.float32)
    out_j = np.asarray(j_prefill(
        jnp.asarray(q), jnp.asarray(kp_j), DUMMY_V,
        *map(jnp.asarray, (pt, q_starts, kv_lens)), 1, sm_scale=SCALE,
        mla_v_dim=R, interpret=True, pages_per_chunk=1))
    out_t = ops.paged_prefill_attention_batch(
        _t(q), kp_t, None, _t(pt), _t(q_starts), _t(kv_lens), 1, sm_scale=SCALE,
        mla_v_dim=R).numpy()
    for n in range(N):
        live = max(int(kv_lens[n] - q_starts[n]), 0)
        np.testing.assert_allclose(out_t[n, :live], out_j[n, :live], atol=ATOL, rtol=0)
    assert not out_t[2].any() and not out_t[..., R:].any()
    one = ops.paged_prefill_attention(_t(q[0]), kp_t, None, _t(pt[0]), 64, 94, 1,
                                      sm_scale=SCALE, mla_v_dim=R)
    assert torch.equal(one, torch.from_numpy(out_t[0])), "a batch row equals its N=1 call"


def test_mla_wrapper_contract(monkeypatch):
    """The MLA mode's unported options raise; a CUDA call launches the
    kernel or raises (here: a width the kernels do not take, then a
    refused build), never runs a plain version, and counts only launches
    that happened."""
    kp = torch.zeros(L, 4, 1, TP, D)
    q, sl, pt = torch.zeros(2, QH, D), torch.tensor([5, 9], dtype=torch.int32), \
        torch.tensor([[1], [2]], dtype=torch.int32)
    ent, sp = torch.zeros(2, 1, D), torch.zeros(2, dtype=torch.int32)
    for kw in (dict(window=8), dict(logit_softcap=30.0)):
        with pytest.raises(NotImplementedError):
            ops.paged_attention_decode(q, kp, None, pt, sl, 0, ent, None, sp, sp,
                                       mla_v_dim=R, **kw)
    with pytest.raises(NotImplementedError, match="one latent pool"):  # two kv heads
        ops.paged_attention_decode(torch.zeros(2, QH, D), torch.zeros(L, 4, 2, TP, D), None,
                                   pt, sl, 0, ent, None, sp, sp, mla_v_dim=R)
    with pytest.raises(NotImplementedError):  # K1r's MLA mode is not ported
        ops.paged_attention(q, kp, kp, pt, sl, 0, mla_v_dim=R)

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
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="640"):  # the toy's 256 lanes
        pa.paged_attention_decode(q, kp, None, pt, sl, 0, ent, None, sp, sp, mla_v_dim=R)
    Dw, H = pa.MLA_HEAD_DIM, 16  # DeepSeek-V2's widths: the kernels take them
    kw = torch.zeros(L, 4, 1, TP, Dw)
    ew = torch.zeros(2, 1, Dw)
    runs = (
        lambda: pa.paged_attention_decode(torch.zeros(2, H, Dw), kw, None, pt, sl, 0, ew,
                                          None, sp, sp, mla_v_dim=pa.MLA_V_DIM),
        lambda: pa.paged_attention_verify(torch.zeros(2, 3, H, Dw), kw, None, pt, sl, 0,
                                          torch.zeros(2, 3, 1, Dw), None, sp[:, None].repeat(1, 3),
                                          sp[:, None].repeat(1, 3), mla_v_dim=pa.MLA_V_DIM),
        lambda: pp.paged_prefill_attention_batch(torch.zeros(2, TP, H, Dw), kw, None, pt,
                                                 sp, sl, 0, mla_v_dim=pa.MLA_V_DIM),
        lambda: pa.write_prefill_kv_single(kw, torch.zeros(1, TP, Dw), sp[:1] + 1, 0),
    )
    for run in runs:
        with pytest.raises(RuntimeError, match="build refused"):
            run()
    assert not calls, "no plain version ran"
    assert ops.launch_counts() == before
