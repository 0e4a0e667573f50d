"""The port's MLA family against the JAX package's, on the same parameters.

``MLAConfig.toy`` at float32: numpy draws the parameters into the JAX
package's tree, ``params_from_jax`` hands the same numbers to the port, and
both packages run a batched prefill, a decode step and a verify step over
one float32 latent pool (JAX with its Pallas kernels in interpret mode, the
port with its kernels' plain versions).  Each JAX step is compiled as one
program without XLA's slow optimisation passes, and its page tables hold one
page: interpret mode makes a large program, and its DMA chunk loop grows
with the table width.

Tolerances, as tests/test_torch_llama.py's: logits within 1e-4 (float32
matmuls summed in different orders by XLA and PyTorch); the pools hold the
same written slots (identical zero pattern) with values within 1e-5, the
latent entries being the projections' outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.models import mla as jm
from kvcached_tpu_torch.models import mla as tm
from kvcached_tpu_torch.models.adapter import as_adapter
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_step

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

P, TP = 12, 32


def numpy_jax_mla_params(jcfg, seed=0):
    """The JAX package's MLA parameter tree for ``jcfg``, drawn with numpy
    into the structure ``jax.eval_shape`` gives (nothing is compiled):
    norms are ones, every other leaf normal / sqrt(its input width), as
    ``init_mla_params`` draws them.  Returns (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.init_mla_params(jcfg, k), jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return np.ones(s.shape, s.dtype)
        fan_in = s.shape[-1] if "embed" in name else s.shape[-2]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(jnp.asarray, tree), tree


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_pools(t, j):
    j = np.asarray(j)
    np.testing.assert_array_equal(t.numpy() != 0, j != 0)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)


def test_config_params_and_adapter():
    """The configs, the parameter names and shapes (params_from_jax and the
    port's own init, which runs on the card unless asked for the CPU), and
    the adapter's single-pool geometry."""
    for jcfg, tcfg in ((jm.MLAConfig.toy(), tm.MLAConfig.toy()),
                       (jm.MLAConfig(), tm.MLAConfig())):
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "kv_lora_rank",
                  "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rope_theta",
                  "latent_dim", "cache_head_dim", "sm_scale", "num_kv_heads",
                  "num_kv_buffers"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
    lite = tm.MLAConfig.deepseek_v2_lite()
    assert (lite.cache_head_dim, lite.num_heads, lite.num_layers) == (640, 16, 27)
    jcfg = jm.MLAConfig.toy(dtype="float32")
    tcfg = tm.MLAConfig.toy(dtype="float32")
    _, tree = numpy_jax_mla_params(jcfg)
    ported = params_from_jax(tree, tcfg, device="cpu")
    drawn = tm.init_mla_params(tcfg, seed=0, device="cpu")
    assert isinstance(ported, tm.MLAModel) and isinstance(drawn, tm.MLAModel)
    for model in (ported, drawn):
        assert set(model.layers) == set(tree["layers"])
        for k, v in tree["layers"].items():
            assert tuple(model.layers[k].shape) == v.shape, k
    np.testing.assert_array_equal(ported.layers["w_uk"].numpy(), tree["layers"]["w_uk"])
    ad = as_adapter(tcfg)
    assert (ad.num_kv_heads, ad.head_dim, ad.num_kv_buffers, ad.window) == (1, 256, 1, None)
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_mla_params(tcfg)


def test_prefill_decode_verify_match_jax():
    """A batched prefill of two rows of different lengths, then a decode
    step (one write discarded), then a verify step of T=2 fed tokens (one
    write discarded), continuing from the same pools.  A cache-hit chunk
    (q_start > 0) is held at the kernel level (test_torch_mla_ops.py) and
    through the engine's prefix cache (test_torch_mla_engine.py)."""
    jcfg = jm.MLAConfig.toy(dtype="float32")
    jparams, tree = numpy_jax_mla_params(jcfg)
    tcfg = tm.MLAConfig.toy(dtype="float32")
    tparams = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    N, T = 2, 32
    tokens = rng.integers(0, jcfg.vocab_size, (N, T)).astype(np.int32)
    q_starts = np.array([0, 0], np.int32)
    true_lens = np.array([20, 25], np.int32)
    positions = (q_starts[:, None] + np.arange(T)[None]).astype(np.int32)
    chunk_pages = np.array([[3], [5]], np.int32)
    page_tables = chunk_pages.copy()
    kp = np.zeros((jcfg.num_layers, P, 1, TP, jcfg.cache_head_dim), np.float32)

    j_logits, jk, _ = jax_step(
        jm.mla_prefill_batch_step, jcfg, jparams,
        *map(jnp.asarray, (tokens, positions, kp)), None,
        *map(jnp.asarray, (chunk_pages, page_tables, q_starts, true_lens)))
    t_logits, tk, tv = tm.mla_prefill_batch_step(
        tparams, tcfg, *map(_t, (tokens, positions, kp)), None,
        *map(_t, (chunk_pages, page_tables, q_starts, true_lens)))
    assert tv is None
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    _close_pools(tk, jk)

    toks = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    pos = q_starts + true_lens
    seq_lens = pos + 1
    slot_pages = page_tables[np.arange(N), pos // TP].astype(np.int32)
    slot_pages[1] = 0  # row 1's write is discarded
    slot_offsets = (pos % TP).astype(np.int32)
    j_logits, jk, _ = jax_step(
        jm.mla_decode_step, jcfg, jparams, *map(jnp.asarray, (toks, pos)), jk, None,
        *map(jnp.asarray, (page_tables, slot_pages, slot_offsets, seq_lens)))
    t_logits, tk, _ = tm.mla_decode_step(
        tparams, tcfg, *map(_t, (toks, pos)), tk, None,
        *map(_t, (page_tables, slot_pages, slot_offsets, seq_lens)))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    _close_pools(tk, jk)

    Tv = 2
    vtok = rng.integers(0, jcfg.vocab_size, (N, Tv)).astype(np.int32)
    vpos = (seq_lens[:, None] + np.arange(Tv)[None]).astype(np.int32)
    vlens = (seq_lens + Tv).astype(np.int32)
    vpages = np.take_along_axis(page_tables, vpos // TP, 1).astype(np.int32)
    vpages[0, 1] = 0  # a discarded write
    voffs = (vpos % TP).astype(np.int32)
    j_logits, jk, _ = jax_step(
        jm.mla_verify_step, jcfg, jparams, *map(jnp.asarray, (vtok, vpos)), jk, None,
        *map(jnp.asarray, (page_tables, vpages, voffs, vlens)))
    t_logits, tk, _ = tm.mla_verify_step(
        tparams, tcfg, *map(_t, (vtok, vpos)), tk, None,
        *map(_t, (page_tables, vpages, voffs, vlens)))
    assert t_logits.shape == (N, Tv, tcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    _close_pools(tk, jk)


def test_prefill_step_is_batch_row():
    """The single-sequence step equals its row of the batched step, bitwise
    (a cache-hit chunk: q_start one page in)."""
    tcfg = tm.MLAConfig.toy(dtype="float32")
    tparams = tm.init_mla_params(tcfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    T = 32
    tokens = _t(rng.integers(0, tcfg.vocab_size, T).astype(np.int32))
    pt = torch.tensor([4, 6, 0], dtype=torch.int32)
    kp = torch.zeros(tcfg.num_layers, P, 1, TP, tcfg.cache_head_dim)
    kp[:, 4] = _t(rng.standard_normal(kp[:, 4].shape).astype(np.float32))
    pos = TP + torch.arange(T, dtype=torch.int32)
    one, k1, _ = tm.mla_prefill_step(tparams, tcfg, tokens, pos, kp.clone(), None,
                                     pt[1:2], pt, TP, 25)
    many, k2, _ = tm.mla_prefill_batch_step(
        tparams, tcfg, tokens[None], pos[None], kp.clone(), None, pt[None, 1:2], pt[None],
        torch.tensor([TP]), torch.tensor([25]))
    assert torch.equal(one, many[0]) and torch.equal(k1, k2)
