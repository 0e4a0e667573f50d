"""The plain version of the port's verify kernel (K4) and the Llama verify
step against the JAX package's, on the same numpy inputs (float32,
head_dim 128, page_tokens 16); K4's wrapper contract on the CPU.

Tolerances: pool writes are copies, so K4's pools must be equal element by
element; attention outputs agree within atol 1e-5 over the live queries
(both sides compute in float32, in different summation orders).  A query is
live when its position ``seq_len - T + t`` lies in ``[0, table width)``:
the engine discards the others, and there the JAX kernel reads a clamped
page where the port sees no key.  The Llama verify step: logits within
1e-4 and pools within 1e-5 (the K/V are XLA's vs PyTorch's matmul outputs),
as in tests/test_torch_llama.py.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.models import llama as jl
from kvcached_tpu.ops.paged_attention import paged_attention_verify as j_verify
from kvcached_tpu_torch import ops
from kvcached_tpu_torch.models import llama as tl
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import numpy_jax_params

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, KH, QH, TP, D = 2, 24, 2, 4, 16, 128


def _pools(rng, num_pages=P):
    k = rng.standard_normal((L, num_pages, KH, TP, D)).astype(np.float32)
    v = rng.standard_normal((L, num_pages, KH, TP, D)).astype(np.float32)
    k[:, 0] = 0.0  # the zero page
    v[:, 0] = 0.0
    return k, v


def _t(x):
    return torch.from_numpy(np.array(x))


def _slots(page_tables, positions):
    """Slot (page, offset) of each fed token; positions past the table go
    to the zero page, as the engine routes them."""
    maxp = page_tables.shape[1]
    inside = positions < maxp * TP
    idx = np.minimum(positions, maxp * TP - 1) // TP
    pages = np.where(inside, np.take_along_axis(page_tables, idx, 1), 0)
    return pages.astype(np.int32), (positions % TP).astype(np.int32)


def _verify_case(seed=0, T=4):
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng)
    B, maxp = 5, 4
    pages = rng.permutation(np.arange(1, P))
    # row 0: long; row 1: long, one discarded slot; row 2: overhangs its
    # table by 2 < T; row 3: padding (seq_len 0, all slots discarded);
    # row 4: short
    seq_lens = np.array([60, 50, maxp * TP + 2, 0, 7], np.int32)
    page_tables = np.zeros((B, maxp), np.int32)
    for b, s in enumerate(seq_lens):
        n = min(-(-s // TP), maxp)
        page_tables[b, :n] = pages[b * maxp : b * maxp + n]
    positions = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
    slot_pages, slot_offsets = _slots(page_tables, positions)
    slot_pages[1, 1] = 0
    slot_pages[3] = 0
    q = rng.standard_normal((B, T, QH, D)).astype(np.float32)
    k_new = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    return (q, kp, vp, page_tables, seq_lens, 1, k_new, v_new, slot_pages,
            slot_offsets)


def _live(seq_lens, T, maxp):
    pos = seq_lens[:, None] - T + np.arange(T)[None]
    return (pos >= 0) & (pos < maxp * TP)


def test_verify_plain_matches_jax():
    """K4 with a window, a discarded slot, a row overhanging its table, a
    padding row and two long rows; the unwindowed verify is held against
    JAX through the Llama verify step below."""
    window, T = 24, 4
    args = _verify_case(T=T)
    out_j, kp_j, vp_j = j_verify(
        *[jnp.asarray(a) for a in args[:5]], args[5],
        *[jnp.asarray(a) for a in args[6:]], interpret=True, window=window)
    t = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    out_t, kp_t, vp_t = ops.paged_attention_verify(*t, window=window)
    assert kp_t.data_ptr() == t[1].data_ptr(), "pool updated in place"
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
    live = _live(args[4], T, args[3].shape[1])
    assert live.sum() == 14 and not live[3].any() and live[2].tolist() == [1, 1, 0, 0]
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               atol=ATOL, rtol=0)
    assert not out_t[3].any(), "a zero-length row gives zeros"


def test_verify_plain_equals_chained_decode():
    """One verify call over T fed tokens equals T chained K1 decode steps:
    the same outputs and the same pool bytes (the port's counterpart of
    tests/test_spec_decode.py's test_verify_matches_sequential_decode)."""
    rng = np.random.default_rng(1)
    kp, vp = (_t(a) for a in _pools(rng, 16))
    B, T = 3, 4
    base = np.array([5, 17, 30])  # row lengths with the first fed token
    tables = np.zeros((B, 4), np.int32)
    tables[0, :1] = [1]
    tables[1, :2] = [2, 3]
    tables[2, :3] = [4, 5, 6]
    q = _t(rng.standard_normal((B, T, QH, D)).astype(np.float32))
    k_new = _t(rng.standard_normal((B, T, KH, D)).astype(np.float32))
    v_new = _t(rng.standard_normal((B, T, KH, D)).astype(np.float32))
    pos = np.stack([base - 1 + j for j in range(T)], 1)
    slot_pages, slot_offsets = _slots(tables, pos)
    kv, vv = kp.clone(), vp.clone()
    out_v, _, _ = ops.paged_attention_verify(
        q, kv, vv, _t(tables), _t((base - 1 + T).astype(np.int32)), 0, k_new,
        v_new, _t(slot_pages), _t(slot_offsets))
    outs = []
    for j in range(T):
        o, _, _ = ops.paged_attention_decode(
            q[:, j], kp, vp, _t(tables), _t((base + j).astype(np.int32)), 0,
            k_new[:, j], v_new[:, j], _t(slot_pages[:, j]), _t(slot_offsets[:, j]))
        outs.append(o)
    np.testing.assert_allclose(out_v.numpy(), torch.stack(outs, 1).numpy(), atol=ATOL, rtol=0)
    assert torch.equal(kv, kp) and torch.equal(vv, vp)


def test_llama_verify_step_matches_jax():
    jcfg = jl.LlamaConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_params(jcfg)
    tcfg = tl.LlamaConfig.toy(dtype="float32")
    tparams = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    kp, vp = (a[:, :16] for a in _pools(rng))
    B, T = 2, 4
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    seq_lens = np.array([21, 36], np.int32)
    positions = (seq_lens[:, None] - T + np.arange(T)[None]).astype(np.int32)
    tables = np.array([[3, 7, 0, 0], [5, 9, 11, 0]], np.int32)
    slot_pages, slot_offsets = _slots(tables, positions)
    slot_pages[1, 3] = 0  # a discarded write
    j_logits, jk, jv = jl.llama_verify_step(
        jparams, jcfg, *map(jnp.asarray, (tokens, positions, kp, vp, tables,
                                          slot_pages, slot_offsets, seq_lens)),
        interpret=True)
    tk, tv = _t(kp), _t(vp)
    t_logits, tk, tv = tl.llama_verify_step(
        tparams, tcfg, *map(_t, (tokens, positions)), tk, tv,
        *map(_t, (tables, slot_pages, slot_offsets, seq_lens)))
    assert t_logits.shape == (B, T, tcfg.vocab_size) and t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.numpy() != 0, np.asarray(j) != 0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_verify_wrapper_contract(monkeypatch):
    """Unported modes raise; a CUDA call launches the kernel or raises (here:
    too many query rows for a block, then a refused build), never runs the
    plain version, and counts only launches that happened."""
    q, kp, vp, pt, sl, layer, kn, vn, spg, sof = map(
        lambda a: _t(a) if isinstance(a, np.ndarray) else a, _verify_case())
    for kw in (dict(mla_v_dim=64), dict(k_scales=torch.ones(L, KH)),
               dict(logit_softcap=30.0)):
        with pytest.raises(NotImplementedError):
            ops.paged_attention_verify(q, kp, vp, pt, sl, layer, kn, vn, spg, sof, **kw)
    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")
    from kvcached_tpu_torch.ops import _build

    def no_build(name):
        raise RuntimeError("build refused")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(pa, "_on_cpu", lambda *ts: False)
    calls = []
    monkeypatch.setattr(pa, "paged_attention_verify_plain", lambda *a, **k: calls.append(a))
    before = pa.paged_attention_verify.launches
    wide = torch.zeros(q.shape[0], 33, QH, D)  # 33 tokens x group 2 > 64 rows
    with pytest.raises(ValueError, match="query rows"):
        pa.paged_attention_verify(wide, kp, vp, pt, sl, layer, kn, vn, spg, sof)
    with pytest.raises(RuntimeError, match="build refused"):
        pa.paged_attention_verify(q, kp, vp, pt, sl, layer, kn, vn, spg, sof)
    assert not calls, "the plain version never ran"
    assert pa.paged_attention_verify.launches == before
