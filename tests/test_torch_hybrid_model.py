"""The port's hybrid family (Gemma2's layer groups) against the JAX
package's: the config's group structure, the parameters, and a batched
prefill followed by a decode step on the same parameters.

The toy has four layers in two groups (full attention and a window of 8
tokens, so the window cuts inside a 32-token page) over one shared float32
arena, with every Gemma2 knob on: the tanh GELU, ``(1 + w)`` norms, the
embedding scale, the post norms, ``query_pre_attn_scalar``, and attention
and final soft-caps small enough to change the logits by far more than the
tolerance (asserted).  Norm weights are drawn (not zeros), so the ``1 + w``
convention is exercised.  The JAX steps run with their Pallas kernels in
interpret mode, each compiled as one program at XLA's lowest optimisation
level, over one-page tables.

Tolerances: logits within 1e-4 (float32 matmuls summed in different orders
by XLA and PyTorch); pools hold the same written slots with values within
1e-5, the K/V being the projections' outputs.  The slots of a prefill page
past its row's true length hold the K/V of padding queries, which no step
reads (a decode writes its slot before it attends to it).  From the second
layer on they differ between the two packages wherever the window leaves a
padding query no key: the JAX kernel masks with a large finite number and
averages the masked values, the port gives zeros.  So those slots are
compared only for being written.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.models import hybrid as jh
from kvcached_tpu.models.hf_loader import _gemma2_config
from kvcached_tpu_torch.models import hybrid as th
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

#: the Gemma2 knobs at toy size; the caps bite (scores and logits reach a
#: few times them)
GEMMA_TOY = dict(dtype="float32", window=8, act="gelu_tanh", norm_offset=True,
                 embed_scale=True, post_norms=True, query_scale=16.0,
                 attn_softcap=2.0, final_softcap=0.5)
#: Gemma-2-27B's published config.json (google/gemma-2-27b), the fields the
#: JAX package's loader reads
GEMMA2_27B_HF = dict(
    num_hidden_layers=46, hidden_size=4608, num_attention_heads=32,
    num_key_value_heads=16, head_dim=128, intermediate_size=36864,
    vocab_size=256000, query_pre_attn_scalar=144, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh",
)


def numpy_hybrid_params(jcfg, seed=0):
    """The JAX hybrid parameter tree for ``jcfg``, drawn with numpy into
    the tree ``jax.eval_shape`` gives (nothing compiled): norms 0.1 x
    normal (q/k norms 1 + that), every other leaf normal / sqrt(its input
    width).  Returns (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jh.init_hybrid_params(jcfg, k), jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            w = 0.1 * rng.standard_normal(s.shape)
            return (w + (1.0 if ("q_norm" in name or "k_norm" in name) else 0.0)).astype(s.dtype)
        fan_in = s.shape[-2] if len(s.shape) == 3 or "lm_head" in name else s.shape[-1]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def toy():
    jcfg = jh.HybridConfig.toy(**GEMMA_TOY)
    jparams, tree = numpy_hybrid_params(jcfg)
    tcfg = th.HybridConfig.toy(**GEMMA_TOY)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


GROUP_FIELDS = ("group_windows", "group_index", "layer_in_group", "group_layer_counts",
                "equal_groups", "layers_per_group")


def test_config_and_params_match_jax(toy):
    """The toy's and Gemma-2-27B's group structure equal the JAX package's;
    ``gemma2_27b()`` equals what the JAX loader makes of the published
    config, field by field; ``params_from_jax`` maps the hybrid tree (the
    post norms included) and the port's own init stores the norms as zeros
    under the ``(1 + w)`` convention, on the card unless asked for the
    CPU."""
    pairs = [(th.HybridConfig.toy(), jh.HybridConfig.toy()),
             (th.HybridConfig.toy(num_layers=6, local_rope_theta=1e4),
              jh.HybridConfig.toy(num_layers=6, local_rope_theta=1e4)),
             (th.HybridConfig.gemma2_27b(), _gemma2_config(GEMMA2_27B_HF, "bfloat16"))]
    for t, j in pairs:
        for f in GROUP_FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        for g in range(len(t.group_windows)):
            assert t.rope_for_group(g) == j.rope_for_group(g)
    t, j = pairs[-1]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.group_windows == (4096, None) and t.layers_per_group == 23

    jcfg, jparams, tcfg, tparams = toy
    assert isinstance(tparams, th.HybridModel)
    assert set(tparams.layers) == set(jparams["layers"]) >= {"post_attn_norm", "post_ffw_norm"}
    for name in ("post_attn_norm", "w_gate", "attn_norm"):
        np.testing.assert_array_equal(tparams.layers[name].numpy(),
                                      np.asarray(jparams["layers"][name]))
    np.testing.assert_array_equal(tparams.final_norm.numpy(), np.asarray(jparams["final_norm"]))
    init = th.init_hybrid_params(dataclasses.replace(tcfg, num_layers=2, layer_windows=(None, 8)),
                                 device="cpu")
    assert set(init.layers) == set(tparams.layers)
    assert not init.layers["post_ffw_norm"].any() and not init.final_norm.any()
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            th.init_hybrid_params(tcfg)


def _close_pools(t, j, pad):
    """Equal written slots; ``pad`` [pages, page_tokens] marks the padding
    slots, which are compared only for being written."""
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(t != 0, j != 0)
    real = ~pad[None, :, None, :, None]
    np.testing.assert_allclose(np.where(real, t, 0), np.where(real, j, 0), atol=1e-5, rtol=0)


def test_prefill_batch_then_decode_match(toy):
    """A batched prefill of two rows and a decode step, each layer writing
    and attending through its own group's page row; the caps change the
    logits."""
    jcfg, jparams, tcfg, tparams = toy
    rng = np.random.default_rng(0)
    N, T, tp = 2, 32, 32
    tokens = rng.integers(0, jcfg.vocab_size, (N, T)).astype(np.int32)
    q_starts = np.zeros(N, np.int32)
    true_lens = np.array([20, 31], np.int32)
    positions = (q_starts[:, None] + np.arange(T)[None]).astype(np.int32)
    # one 32-token page a row in each group: [N, G, 1]
    chunk_pages = np.array([[[3], [4]], [[5], [6]]], np.int32)
    page_tables = chunk_pages.copy()
    shape = (jcfg.layers_per_group, 8, jcfg.num_kv_heads, tp, jcfg.head_dim)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)

    # the decode step that follows: its token is the prefill's greedy pick;
    # row 1's write in the sliding group goes to the zero page (discarded)
    pos = true_lens.copy()
    seq_lens = pos + 1
    slot_pages = page_tables[:, :, 0].T.copy()  # [G, N]
    slot_pages[1, 1] = 0
    slot_offsets = (pos % tp).astype(np.int32)
    tables = page_tables.transpose(1, 0, 2).copy()  # [G, N, 1]

    def prefill_then_decode(params, *a):
        logits, k, v = jh.hybrid_prefill_batch_step(params, jcfg, *a[:8], interpret=True)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        return (logits, k, v, toks,
                *jh.hybrid_decode_step(params, jcfg, toks, a[8], k, v, *a[9:], interpret=True))

    (j_logits, jk, jv, toks, jd_logits, jdk, jdv) = (np.asarray(x) for x in jax_lowest(
        prefill_then_decode, jparams,
        *map(jnp.asarray, (tokens, positions, kp, vp, chunk_pages, page_tables, q_starts,
                           true_lens, pos, tables, slot_pages, slot_offsets, seq_lens))))
    targs = [torch.from_numpy(a) for a in (tokens, positions)]
    rest = [torch.from_numpy(a) for a in (chunk_pages, page_tables, q_starts, true_lens)]
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits, tk, tv = th.hybrid_prefill_batch_step(tparams, tcfg, *targs, tk, tv, *rest)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    pad = np.zeros(shape[1:4:2], bool)  # [pages, page_tokens]
    for n in range(N):
        pad[chunk_pages[n, :, 0], true_lens[n]:] = True
    _close_pools(tk, jk, pad)
    _close_pools(tv, jv, pad)
    # each cap alone moves the logits by far more than the tolerance
    for off in (dict(attn_softcap=None), dict(final_softcap=None)):
        uncapped = th.hybrid_prefill_batch_step(
            tparams, dataclasses.replace(tcfg, **off), *targs,
            torch.zeros(shape), torch.zeros(shape), *rest)[0]
        assert (uncapped - t_logits).abs().max().item() > 1e-2, off

    # the decode step, continuing from the prefilled pools
    pad[slot_pages, pos[None]] = False  # the decode's written slots
    t_logits, tk, tv = th.hybrid_decode_step(
        tparams, tcfg, *map(torch.from_numpy, (toks, pos)), tk, tv,
        *map(torch.from_numpy, (tables, slot_pages, slot_offsets, seq_lens)))
    np.testing.assert_allclose(t_logits.numpy(), jd_logits, atol=1e-4, rtol=0)
    _close_pools(tk, jdk, pad)
    _close_pools(tv, jdv, pad)
