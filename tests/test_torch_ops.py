"""Plain versions of the port's kernels (K1, K2, K3) against the JAX
package's Pallas kernels run with ``interpret=True``, on the same numpy
inputs (float32, head_dim 128, page_tokens 16); K1r against the dense
oracle.

Tolerances: pool writes are copies, so pools must be equal element by
element; attention outputs agree within atol 1e-5 (both sides compute in
float32, in different summation orders).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import torch

from kvcached_tpu.ops.paged_attention import (
    paged_attention_decode as j_paged_attention_decode,
    write_prefill_kv as j_write_prefill_kv,
)
from kvcached_tpu.ops.paged_prefill import (
    paged_prefill_attention_batch as j_paged_prefill_attention_batch,
)
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ATOL = 1e-5
L, P, KH, QH, TP, D = 2, 24, 2, 4, 16, 128


def _pools(rng):
    k = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    v = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    k[:, 0] = 0.0  # the zero page
    v[:, 0] = 0.0
    return k, v


def _t(x):
    return torch.from_numpy(np.array(x))


def _decode_case(seed=0):
    rng = np.random.default_rng(seed)
    k_pool, v_pool = _pools(rng)
    B, maxp = 4, 2
    pages = rng.permutation(np.arange(1, P))
    page_tables = np.zeros((B, maxp), np.int32)
    # row 0: a full table (2 pages), row 1: slot page 0 (write discarded),
    # row 2: zero-length padded row, row 3: short
    seq_lens = np.array([32, 21, 0, 7], np.int32)
    for b, s in enumerate(seq_lens):
        n = -(-s // TP)
        page_tables[b, :n] = pages[b * maxp : b * maxp + n]
    pos = np.maximum(seq_lens - 1, 0)
    slot_pages = page_tables[np.arange(B), pos // TP].copy()
    slot_pages[1] = 0
    slot_pages[2] = 0
    slot_offsets = (pos % TP).astype(np.int32)
    q = rng.standard_normal((B, QH, D)).astype(np.float32)
    k_new = rng.standard_normal((B, KH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, KH, D)).astype(np.float32)
    return (q, k_pool, v_pool, page_tables, seq_lens, 1, k_new, v_new,
            slot_pages, slot_offsets)


def test_decode_plain_matches_jax():
    """K1 with a window, a page-0 (discarded) write and a zero-length row;
    the unwindowed decode is held against JAX by tests/test_torch_engine.py."""
    window = 24
    args = _decode_case()
    out_j, kp_j, vp_j = jax_lowest(
        lambda q, kp, vp, pt, sl, *rest: j_paged_attention_decode(
            q, kp, vp, pt, sl, args[5], *rest, interpret=True, window=window),
        *[jnp.asarray(a) for a in args[:5] + args[6:]])
    t = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    out_t, kp_t, vp_t = ops.paged_attention_decode(*t, window=window)
    assert kp_t.data_ptr() == t[1].data_ptr(), "pool updated in place"
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    assert not out_t[2].any(), "a zero-length row gives zeros"


def test_readonly_plain_matches_reference():
    """K1r (K1 with the write off) against the dense float32 oracle, the
    port of ``paged_attention_reference``."""
    q, kp, vp, pt, sl = map(_t, _decode_case(1)[:5])
    before = kp.clone()
    out = ops.paged_attention(q, kp, vp, pt, sl, 1)
    assert torch.equal(kp, before), "read-only"
    ref = ops.paged_attention_reference(q, kp[1], vp[1], pt, sl)
    live = sl > 0
    np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(), atol=ATOL, rtol=0)


def test_prefill_write_plain_matches_jax():
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    T = 3 * TP
    k_new = rng.standard_normal((KH, T, D)).astype(np.float32)
    v_new = rng.standard_normal((KH, T, D)).astype(np.float32)
    pages = np.array([5, 0, 9], np.int32)  # middle chunk discarded
    kp_j, vp_j = j_write_prefill_kv(
        *map(jnp.asarray, (kp, vp, k_new, v_new, pages)), 1, interpret=True)
    kp_t, vp_t = ops.write_prefill_kv(*map(_t, (kp, vp, k_new, v_new, pages)), 1)
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
    assert not kp_t[:, 0].any(), "the zero page stays zero"


def _prefill_case(seed=3):
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng)
    N, T, maxp = 3, 32, 3
    pages = rng.permutation(np.arange(1, P))
    page_tables = np.zeros((N, maxp), np.int32)
    page_tables[0, :3] = pages[:3]
    page_tables[1, :2] = pages[3:5]
    q_starts = np.array([16, 0, 0], np.int32)  # row 0 after a cached page
    kv_lens = np.array([16 + 27, 30, 0], np.int32)  # row 2: padding row
    q = rng.standard_normal((N, T, QH, D)).astype(np.float32)
    return q, kp, vp, page_tables, q_starts, kv_lens


def test_prefill_plain_matches_jax():
    """K3 with a window, q_start > 0 and a kv_len = 0 row; the unwindowed
    prefill is held against JAX by tests/test_torch_llama.py."""
    window = 24
    q, kp, vp, pt, qs, kl = _prefill_case()
    out_j = np.asarray(jax_lowest(
        lambda *a: j_paged_prefill_attention_batch(*a, 1, interpret=True, window=window),
        *map(jnp.asarray, (q, kp, vp, pt, qs, kl))))
    out_t = ops.paged_prefill_attention_batch(
        *map(_t, (q, kp, vp, pt, qs, kl)), 1, window=window).numpy()
    for n in range(q.shape[0]):
        live = max(int(kl[n] - qs[n]), 0)  # padding query rows are discarded
        np.testing.assert_allclose(out_t[n, :live], out_j[n, :live], atol=ATOL, rtol=0)
    assert not out_t[2].any(), "a kv_len=0 row gives zeros"
    # rows are independent: the batch equals N serial N=1 calls, bitwise
    for n in range(q.shape[0]):
        one = ops.paged_prefill_attention(
            _t(q[n]), _t(kp), _t(vp), _t(pt[n]), int(qs[n]), int(kl[n]), 1,
            window=window)
        assert torch.equal(one, torch.from_numpy(out_t[n]))
