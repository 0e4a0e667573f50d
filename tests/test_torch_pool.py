"""The port's pool scatter writer against the JAX package's, on the same
numpy inputs (float32): pools must be equal element by element, since the
writer only copies."""

import jax.numpy as jnp
import numpy as np
import torch

from kvcached_tpu.device.pool import write_kv_pages as j_write_kv_pages
from kvcached_tpu_torch.device.pool import write_kv_pages

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, KH, TP, D = 2, 24, 2, 16, 128


def test_write_kv_pages_matches_jax():
    """In place; out-of-range pages are dropped."""
    rng = np.random.default_rng(4)
    kp = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    vp = rng.standard_normal((L, P, KH, TP, D)).astype(np.float32)
    T = 5
    k_new = rng.standard_normal((T, KH, D)).astype(np.float32)
    v_new = rng.standard_normal((T, KH, D)).astype(np.float32)
    pages = np.array([3, 3, 7, P + 5, 11], np.int32)  # one page out of range
    slots = np.array([0, 1, 15, 2, 4], np.int32)
    kp_j, vp_j = j_write_kv_pages(*map(jnp.asarray, (kp, vp)), 1,
                                  *map(jnp.asarray, (k_new, v_new, pages, slots)))
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ptr = kp_t.data_ptr()
    write_kv_pages(kp_t, vp_t, 1, *map(torch.from_numpy, (k_new, v_new, pages, slots)))
    assert kp_t.data_ptr() == ptr
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
