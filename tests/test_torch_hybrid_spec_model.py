"""The port's hybrid verify step (speculative decoding on Gemma2's layer
groups) against the JAX package's, on float32, int8 and float8_e4m3fn
arenas.

The toy of tests/test_torch_hybrid_engine.py: four layers in two groups
(full attention and a 32-token window) over one shared arena, every Gemma2
knob on, caps that bite.  The arena holds prior K/V drawn at random (codes
for the byte pools).  Three rows verify T = 4 fed tokens: on the float32
arena, whose rows have two 32-token pages in each group, row 0's queries
sit past the window, which cuts keys inside the sliding group's first
page; row 1 reaches its position cap, so its last queries are clamped to
the cap and their writes go to the zero page, as the engine routes them;
row 2 is short.  The byte arenas take the same rows within one page (see
the tolerances).  The int8 arena takes scales per model layer
([num_layers, KH], distinct per layer and head), which each group's layers
take rows of.  The three JAX steps (Pallas kernels in interpret mode)
compile as one program at XLA's lowest optimisation level.

Tolerances.  Float32: logits within 1e-4 (float32 matmuls summed in
different orders by XLA and PyTorch), pools within 1e-5 (the written K/V
are the projections' outputs).  Byte pools, in the form
tests/test_torch_mla_quant_engine.py holds the MLA family's: codes equal,
except where float32 noise puts a written value on the other side of a
rounding boundary, there neighbouring codes, at no more than 2% of the
written values; logits within 1.5e-2.  These bounds are wider than the
MLA toy's (0.1%, 5e-3): every layer quantizes the K/V it writes and
rounds q and the softmax weights to bf16 operands, so the packages'
float32 noise (their summation orders) flips codes at rounding boundaries
and turns operands into their bf16 neighbours, and this toy's Gemma2
knobs carry those changes through four layers (at 5e-3 this test fails on
the e4m3 arena, whose logits differ here by up to 9.4e-3).  With one page
a row both sides round the softmax weights against the same maximum;
over two pages the JAX kernel rounds them against each page's running
maximum and the plain version against the row's (as the port's CUDA
kernels do against their tiles'), a valid order that moved the int8
logits of this test by up to 1.4e-2 with two-page rows: the byte arenas'
rows stay within one page.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from kvcached_tpu.models import hybrid as jh
from kvcached_tpu_torch.models import hybrid as th
from kvcached_tpu_torch.weights import params_from_jax
from test_torch_hybrid_engine import TOY
from test_torch_hybrid_model import numpy_hybrid_params
from test_torch_llama import jax_lowest
from test_torch_mla_quant_engine import _same_pools_but_boundaries
from test_torch_quant_ops import NP_DTYPE, _t

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

P, TP, T = 12, 32, 4
MODES = ("float32", "int8", "float8_e4m3fn")
BYTE_LOGITS_ATOL = 1.5e-2
#: written values whose codes may differ between the packages (neighbours)
BOUNDARY_SHARE = 2e-2


def _inputs(rng, cfg, two_pages):
    """Fed tokens, positions and slots as the engine's spec horizon makes
    them (positions clamped at the cap, writes from the cap on discarded,
    lengths unclamped), per-group tables [G, B, 2] or [G, B, 1]."""
    seq_lens0 = np.array([36 if two_pages else 20, 24, 5], np.int32)  # KV written so far
    cap = np.array([63, 26, 63], np.int32)  # each row's last position
    raw = seq_lens0[:, None] + np.arange(T)[None]
    pos = np.minimum(raw, cap[:, None]).astype(np.int32)
    tables = np.array([[[1, 2], [3, 4], [5, 0]], [[6, 7], [8, 9], [10, 0]]], np.int32)
    if not two_pages:
        tables = tables[..., :1].copy()
    slot_pages = np.where(raw[None] >= cap[None, :, None], 0,
                          np.take_along_axis(tables, np.broadcast_to(pos // TP, (2, 3, T)), 2))
    tokens = rng.integers(0, cfg.vocab_size, (3, T)).astype(np.int32)
    return [tokens, pos, tables, slot_pages.astype(np.int32), (pos % TP).astype(np.int32),
            (seq_lens0 + T).astype(np.int32)]


def _arena(rng, cfg, mode):
    """Prior K/V of the shared arena (int8: codes of N(0, 1) at scale
    0.03); page 0 zero."""
    shape = (cfg.layers_per_group, P, cfg.num_kv_heads, TP, cfg.head_dim)
    out = []
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32)
        if mode == "int8":
            x = np.clip(np.round(x / 0.03), -127, 127)
        x = x.astype(NP_DTYPE[mode])
        x[:, 0] = 0
        out.append(x)
    return out


def test_verify_step_matches_jax():
    """float32, int8 (per-model-layer scales) and e4m3 arenas; the window
    cuts row 0's keys, row 1 overflows its cap."""
    jcfg = jh.HybridConfig.toy(**TOY)
    jparams, tree = numpy_hybrid_params(jcfg)
    tcfg = th.HybridConfig.toy(**TOY)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    L, KH = jcfg.num_layers, jcfg.num_kv_heads
    ks = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    vs = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    steps = {m: _inputs(rng, jcfg, m == "float32") for m in MODES}
    arenas = {m: _arena(rng, jcfg, m) for m in MODES}
    scales = {"int8": (ks, vs)}

    def run(p, ks, vs, *a):
        outs = []
        for i, mode in enumerate(MODES):
            kp, vp, tok, pos, *rest = a[8 * i: 8 * i + 8]
            sc = {"quant_scales": (ks, vs)} if mode in scales else {}
            outs.append(jh.hybrid_verify_step(p, jcfg, tok, pos, kp, vp, *rest,
                                              interpret=True, **sc))
        return outs

    got_j = jax_lowest(run, jparams, jnp.asarray(ks), jnp.asarray(vs),
                       *[jnp.asarray(x) for m in MODES for x in arenas[m] + steps[m]])
    for mode, (lj, kj, vj) in zip(MODES, got_j):
        kp, vp = map(_t, arenas[mode])
        targs = list(map(_t, steps[mode]))
        sc = {"quant_scales": tuple(map(_t, scales[mode]))} if mode in scales else {}
        lt, kt, vt = th.hybrid_verify_step(tparams, tcfg, *targs[:2], kp, vp, *targs[2:], **sc)
        if mode == "float32":
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
            for a, b in ((kt, kj), (vt, vj)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
            # the attention cap moves the logits by far more than the tolerance
            uncapped = th.hybrid_verify_step(
                tparams, dataclasses.replace(tcfg, attn_softcap=None), *targs[:2],
                *map(_t, arenas[mode]), *targs[2:])[0]
            assert (uncapped - lt).abs().max().item() > 1e-2
        else:
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=BYTE_LOGITS_ATOL,
                                       rtol=0, err_msg=mode)
            # each model layer writes its row's fed tokens in one group
            written = int((targs[3][0] != 0).sum()) * jcfg.num_layers * KH * jcfg.head_dim
            for what, a, b in (("K", kt, kj), ("V", vt, vj)):
                _same_pools_but_boundaries(mode, a, b, f"{mode} {what}", BOUNDARY_SHARE, written)
        # the discarded writes: the zero page stays zero
        assert not kt[:, 0].float().any() and not vt[:, 0].float().any(), mode
