"""The port's Llama steps against the JAX package's, on the same parameters.

The toy config at float32: numpy draws the parameters into the JAX
package's tree, ``params_from_jax`` hands the same numbers to the port, and
both packages run a batched
prefill and then a decode step over float32 pools (JAX with its Pallas
kernels in interpret mode, the port with its kernels' plain versions).

Tolerances: logits within 1e-4 (float32 matmuls, summed in different orders
by XLA and PyTorch); pools hold the same written slots (identical zero
pattern) with values within 1e-5, the K/V being the projections' outputs;
rope within 1e-4 at positions up to 1000 (float32 cos/sin of large angles
from two libraries).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.models import llama as jl
from kvcached_tpu_torch.models import llama as tl
from kvcached_tpu_torch.weights import params_from_jax

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L_POOL, P, TP = 2, 16, 16


def numpy_jax_params(jcfg, seed=0):
    """The JAX package's parameter tree for ``jcfg``, drawn with numpy: the
    tree's structure comes from ``jax.eval_shape`` (nothing is compiled),
    norms are ones and every other leaf is normal / sqrt(its input width),
    as ``init_llama_params`` draws them.  Returns (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jl.init_llama_params(jcfg, k), jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return np.ones(s.shape, s.dtype)
        fan_in = s.shape[-2] if len(s.shape) == 3 or "lm_head" in name else s.shape[-1]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(jnp.asarray, tree), tree


@contextlib.contextmanager
def jax_one_page_chunks():
    """The JAX package's paged kernels, called inside without an explicit
    ``pages_per_chunk``, copy one page a DMA chunk: a tiling choice that
    leaves their function unchanged (their ``pages_per_chunk`` argument),
    while interpret mode lowers one DMA body for each page a chunk holds
    (~30% of a JAX engine's cost at two-page tables)."""
    chunkers = [(importlib.import_module("kvcached_tpu.ops.paged_attention"),
                 "_pick_pages_per_chunk"),
                (importlib.import_module("kvcached_tpu.ops.paged_prefill"), "_pick_chunk")]
    saved = [getattr(mod, name) for mod, name in chunkers]
    for mod, name in chunkers:
        setattr(mod, name, lambda *args: 1)
    try:
        yield
    finally:
        for (mod, name), fn in zip(chunkers, saved):
            setattr(mod, name, fn)


def jax_compile_lowest(fn, *args):
    """``fn`` compiled for ``args``' shapes as one program at XLA's lowest
    optimisation level, its paged kernels copying one page a DMA chunk
    (:func:`jax_one_page_chunks`): interpret-mode Pallas makes large
    programs, and op-by-op dispatch or XLA's slow passes cost seconds on
    them.  The program can be called again on other arrays of the same
    shapes."""
    with jax_one_page_chunks():
        lowered = jax.jit(fn).lower(*args)
    return lowered.compile({"xla_backend_optimization_level": 0,
                            "xla_llvm_disable_expensive_passes": True})


def jax_lowest(fn, *args):
    """``fn(*args)`` through :func:`jax_compile_lowest`."""
    return jax_compile_lowest(fn, *args)(*args)


@contextlib.contextmanager
def jax_fast_compile():
    """JAX programs compiled inside skip XLA's slow optimisation passes
    (the JAX engines' interpret-mode programs: ~15% of their cost), their
    paged kernels copying one page a DMA chunk (:func:`jax_one_page_chunks`)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with jax_one_page_chunks():
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


def jax_step(step, jcfg, params, *args):
    """The JAX model step ``step(params, jcfg, *args, interpret=True)``
    through ``jax_lowest``."""
    return jax_lowest(lambda p, *a: step(p, jcfg, *a, interpret=True), params, *args)


@pytest.fixture(scope="module")
def toy():
    jcfg = jl.LlamaConfig.toy(dtype="float32", qk_norm=True, attention_bias=True)
    jparams, tree = numpy_jax_params(jcfg)
    tcfg = tl.LlamaConfig.toy(dtype="float32", qk_norm=True, attention_bias=True)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _pools(cfg, tp=TP):
    shape = (cfg.num_layers, P, cfg.num_kv_heads, tp, cfg.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def _close_pools(t, j):
    j = np.asarray(j)
    np.testing.assert_array_equal(t.numpy() != 0, j != 0)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)


def test_config_and_params_map(toy):
    jcfg, jparams, tcfg, tparams = toy
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "intermediate_size", "rope_theta"):
        assert getattr(jcfg, f) == getattr(tcfg, f)
    assert set(tparams.layers) == set(jparams["layers"])
    np.testing.assert_array_equal(tparams.layers["wq"].numpy(),
                                  np.asarray(jparams["layers"]["wq"]))


def test_rope_scalings_match(toy):
    x = np.random.default_rng(2).standard_normal((3, 7, 4, 128)).astype(np.float32)
    pos = np.arange(21, dtype=np.int32).reshape(3, 7) * 50
    for scaling in (None, ("linear", 2.0), ("llama3", 8.0, 1.0, 4.0, 8192.0)):
        np.testing.assert_allclose(
            tl.rope_inv_freqs(128, 500000.0, scaling).numpy(),
            np.asarray(jl.rope_inv_freqs(128, 500000.0, scaling)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0, scaling).numpy(),
            np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling)),
            atol=1e-4, rtol=0)


def test_prefill_batch_then_decode_match(toy):
    jcfg, jparams, tcfg, tparams = toy
    rng = np.random.default_rng(0)
    N, T = 2, 32
    tokens = rng.integers(0, jcfg.vocab_size, (N, T)).astype(np.int32)
    q_starts = np.zeros(N, np.int32)
    true_lens = np.array([20, 31], np.int32)
    positions = (q_starts[:, None] + np.arange(T)[None]).astype(np.int32)
    # one 32-token page a row: the JAX kernels' interpret-mode programs
    # grow with the pages a table holds
    tp = 32
    chunk_pages = np.array([[3], [5]], np.int32)
    page_tables = chunk_pages.copy()
    kp, vp = _pools(jcfg, tp)

    j_logits, jk, jv = jax_step(
        jl.llama_prefill_batch_step, jcfg, jparams,
        *map(jnp.asarray, (tokens, positions, kp, vp, chunk_pages, page_tables,
                           q_starts, true_lens)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits, tk, tv = tl.llama_prefill_batch_step(
        tparams, tcfg, *map(torch.from_numpy, (tokens, positions)), tk, tv,
        *map(torch.from_numpy, (chunk_pages, page_tables, q_starts, true_lens)))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    _close_pools(tk, jk)
    _close_pools(tv, jv)

    # one decode step for both rows, continuing from the prefilled pools
    toks = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    pos = true_lens.copy()
    seq_lens = pos + 1
    slot_pages = page_tables[np.arange(N), pos // tp]
    slot_pages[1] = 0  # row 1's slot is the zero page: its write is discarded
    slot_pages = slot_pages.astype(np.int32)
    slot_offsets = (pos % tp).astype(np.int32)
    j_logits, jk, jv = jax_step(
        jl.llama_decode_step, jcfg, jparams, *map(jnp.asarray, (toks, pos)), jk, jv,
        *map(jnp.asarray, (page_tables, slot_pages, slot_offsets, seq_lens)))
    t_logits, tk, tv = tl.llama_decode_step(
        tparams, tcfg, *map(torch.from_numpy, (toks, pos)), tk, tv,
        *map(torch.from_numpy, (page_tables, slot_pages, slot_offsets, seq_lens)))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    _close_pools(tk, jk)
    _close_pools(tv, jv)


def test_prefill_step_is_batch_row(toy):
    """The single-sequence step equals its row of the batched step, bitwise
    (a cache-hit chunk: q_start one page in)."""
    _, _, tcfg, tparams = toy
    rng = np.random.default_rng(1)
    T = 32
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, T).astype(np.int32))
    pt = torch.tensor([4, 6, 8, 0], dtype=torch.int32)
    kp, vp = (torch.from_numpy(a) for a in _pools(tcfg))
    kp[:, 4] = torch.from_numpy(rng.standard_normal(kp[:, 4].shape).astype(np.float32))
    vp[:, 4] = torch.from_numpy(rng.standard_normal(vp[:, 4].shape).astype(np.float32))
    pos = TP + torch.arange(T, dtype=torch.int32)
    one, k1, v1 = tl.llama_prefill_step(
        tparams, tcfg, tokens, pos, kp.clone(), vp.clone(), pt[1:3], pt, TP, 25)
    many, k2, v2 = tl.llama_prefill_batch_step(
        tparams, tcfg, tokens[None], pos[None], kp.clone(), vp.clone(),
        pt[None, 1:3], pt[None], torch.tensor([TP]), torch.tensor([25]))
    assert torch.equal(one, many[0]) and torch.equal(k1, k2) and torch.equal(v1, v2)
