"""The hybrid family at head_dim 256 (Gemma-2-9B's width) against the JAX
package: ``HybridConfig.gemma2_9b()`` and the port's Gemma2 loader, and a
batched prefill, a decode step and a verify step of a two-layer Gemma2
toy whose query width (4 heads x 256) differs from its hidden size (384).

The toy is a Gemma2 checkpoint written here with numpy (bf16 tensors, as
published checkpoints store them, through the JAX package's
``write_safetensors``; zero-centred norm weights drawn, so the ``1 + w``
convention is exercised; the LM head tied to the embedding) and read by
both loaders: configs equal field by field, parameters element by element
(float32; both loaders only widen, transpose and stack).  Its two layers
are one group each (sliding window 8, cutting inside a 32-token page, and
full attention) over one float32 arena, with every Gemma2 knob on and
attention and final soft-caps small enough to change the logits by far more
than the tolerance (asserted).  The JAX steps run with their Pallas kernels
in interpret mode, compiled as one program at XLA's lowest optimisation
level, over one-page tables.

Tolerances: logits within 1e-4 (float32 matmuls summed in different orders
by XLA and PyTorch); pools hold the same written slots with values within
1e-5.  A prefill page's slots past its row's true length hold padding
queries' K/V, which no step reads; they are compared only for being
written (tests/test_torch_hybrid_model.py says why they may differ).
"""

import dataclasses
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kvcached_tpu.models import hf_loader as jl
from kvcached_tpu.models import hybrid as jh
from kvcached_tpu_torch.models import hf_loader as tl
from kvcached_tpu_torch.models import hybrid as th
from test_torch_hybrid_model import _close_pools
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

#: Gemma-2-9B's published config.json (google/gemma-2-9b), the fields the
#: loaders read
GEMMA2_9B_HF = dict(
    architectures=["Gemma2ForCausalLM"], num_hidden_layers=42, hidden_size=3584,
    num_attention_heads=16, num_key_value_heads=8, head_dim=256, intermediate_size=14336,
    vocab_size=256000, query_pre_attn_scalar=256, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, rms_norm_eps=1e-6,
    rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh",
)
#: the toy checkpoint: Gemma-2-9B's shape cut to two layers and narrow
#: widths, head_dim kept at 256; caps that bite
TOY_HF = dict(GEMMA2_9B_HF, num_hidden_layers=2, hidden_size=384, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=512, vocab_size=512,
              sliding_window=8, attn_logit_softcapping=2.0, final_logit_softcapping=0.5)
TP = 32


def _write_checkpoint(path, hc, seed=0):
    """A Gemma2 checkpoint of ``hc``'s shape: bf16 tensors, projections
    normal / sqrt(fan_in), norm weights 0.1 x normal (zero-centred), the
    LM head tied (absent)."""
    rng = np.random.default_rng(seed)
    E, H, KH, D, F = (hc[k] for k in ("hidden_size", "num_attention_heads",
                                      "num_key_value_heads", "head_dim", "intermediate_size"))
    bf = lambda x: x.astype(np.float32).astype(ml_dtypes.bfloat16)  # noqa: E731
    mat = lambda o, i: bf(rng.standard_normal((o, i)) / np.sqrt(i))  # noqa: E731
    norm = lambda: bf(0.1 * rng.standard_normal(E))  # noqa: E731
    t = {"model.embed_tokens.weight": mat(hc["vocab_size"], E), "model.norm.weight": norm()}
    for i in range(hc["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": mat(H * D, E),
            p + "self_attn.k_proj.weight": mat(KH * D, E),
            p + "self_attn.v_proj.weight": mat(KH * D, E),
            p + "self_attn.o_proj.weight": mat(E, H * D),
            p + "post_attention_layernorm.weight": norm(),
            p + "pre_feedforward_layernorm.weight": norm(),
            p + "post_feedforward_layernorm.weight": norm(),
            p + "mlp.gate_proj.weight": mat(F, E),
            p + "mlp.up_proj.weight": mat(F, E),
            p + "mlp.down_proj.weight": mat(E, F),
        })
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hc))
    jl.write_safetensors(t, str(path / "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    ckpt = _write_checkpoint(tmp_path_factory.mktemp("gemma2") / "toy", TOY_HF)
    jcfg, jparams = jl.params_from_hf(ckpt, dtype="float32")
    tcfg, tparams = tl.params_from_hf(ckpt, dtype="float32", device="cpu")
    return jcfg, jparams, tcfg, tparams, ckpt


def test_gemma2_9b_config_and_loader_match_jax(toy):
    """``gemma2_9b()`` and the port's loader equal what the JAX loader makes
    of the published config, field by field; the toy checkpoint loads to
    the same config and parameters in both packages."""
    want = jl._gemma2_config(GEMMA2_9B_HF, "bfloat16")
    for got in (th.HybridConfig.gemma2_9b(), tl._gemma2_config(GEMMA2_9B_HF, "bfloat16")):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = th.HybridConfig.gemma2_9b()
    assert cfg.group_windows == (4096, None) and cfg.layers_per_group == 21
    assert cfg.head_dim == 256 and cfg.num_heads * cfg.head_dim == 4096 != cfg.hidden_size

    jcfg, jparams, tcfg, tparams, ckpt = toy
    assert isinstance(tcfg, th.HybridConfig) and isinstance(tparams, th.HybridModel)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.head_dim == 256 and tcfg.group_windows == (8, None)
    assert set(tparams.layers) == set(jparams["layers"]) >= {"post_attn_norm", "post_ffw_norm"}
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(tparams.layers[k].numpy(), np.asarray(v), err_msg=k)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(getattr(tparams, k).numpy(), np.asarray(jparams[k]),
                                      err_msg=k)
    if not torch.cuda.is_available():  # the loader defaults to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.params_from_hf(ckpt, dtype="float32")


def test_hd256_steps_match_jax(toy):
    """A batched prefill of two rows, a decode step and a verify step of
    T = 3 fed tokens, each layer writing and attending through its own
    group's page row; the caps change the logits."""
    jcfg, jparams, tcfg, tparams, _ = toy
    rng = np.random.default_rng(0)
    N, T, Tv = 2, 32, 3
    tokens = rng.integers(0, jcfg.vocab_size, (N, T)).astype(np.int32)
    q_starts = np.zeros(N, np.int32)
    true_lens = np.array([20, 27], np.int32)
    positions = (q_starts[:, None] + np.arange(T)[None]).astype(np.int32)
    # one 32-token page a row in each group: [N, G, 1]
    chunk_pages = np.array([[[3], [4]], [[5], [6]]], np.int32)
    shape = (jcfg.layers_per_group, 8, jcfg.num_kv_heads, TP, jcfg.head_dim)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tables = chunk_pages.transpose(1, 0, 2).copy()  # [G, N, 1]
    # the decode step: row 1's write in the sliding group is discarded
    pos = true_lens.copy()
    slot_pages = tables[:, :, 0].copy()  # [G, N]
    slot_pages[0, 1] = 0
    # the verify step after it: row 0's last fed token discarded in the
    # full group
    vpos = (true_lens + 1)[:, None] + np.arange(Tv)[None]
    vslots = np.repeat(tables, Tv, axis=2)  # [G, N, Tv]
    vslots[1, 0, -1] = 0
    vtokens = rng.integers(0, jcfg.vocab_size, (N, Tv)).astype(np.int32)

    jax_in = (tokens, positions, kp, vp, chunk_pages, chunk_pages, q_starts, true_lens, pos,
              tables, slot_pages, (pos % TP).astype(np.int32), pos + 1,
              vtokens, vpos.astype(np.int32))
    # the verify step's slots, offsets and lengths follow its tables
    vrest = (vslots, (vpos % TP).astype(np.int32), (vpos[:, -1] + 1).astype(np.int32))

    def steps_all(params, *a):
        logits, k, v = jh.hybrid_prefill_batch_step(params, jcfg, *a[:8], interpret=True)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        dl, k, v = jh.hybrid_decode_step(params, jcfg, toks, a[8], k, v, *a[9:13],
                                         interpret=True)
        vl, k2, v2 = jh.hybrid_verify_step(params, jcfg, a[13], a[14], k, v, a[9], *a[15:],
                                           interpret=True)
        return logits, k, v, toks, dl, vl, k2, v2

    j_logits, jk, jv, toks, jd, jvl, jk2, jv2 = (np.asarray(x) for x in jax_lowest(
        steps_all, jparams, *map(jnp.asarray, jax_in + vrest)))

    t = torch.from_numpy
    tk, tv = t(kp.copy()), t(vp.copy())
    rest = [t(a) for a in (chunk_pages, chunk_pages, q_starts, true_lens)]
    t_logits, tk, tv = th.hybrid_prefill_batch_step(tparams, tcfg, t(tokens), t(positions),
                                                    tk, tv, *rest)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=1e-4, rtol=0)
    pad = np.zeros(shape[1:4:2], bool)  # [pages, page_tokens]
    for n in range(N):
        pad[chunk_pages[n, :, 0], true_lens[n]:] = True
    _close_pools(tk, jk, pad)
    _close_pools(tv, jv, pad)
    # each cap alone moves the logits by far more than the tolerance
    for off in (dict(attn_softcap=None), dict(final_softcap=None)):
        uncapped = th.hybrid_prefill_batch_step(
            tparams, dataclasses.replace(tcfg, **off), t(tokens), t(positions),
            torch.zeros(shape), torch.zeros(shape), *rest)[0]
        assert (uncapped - t_logits).abs().max().item() > 1e-2, off

    # the decode step, continuing from the prefilled pools
    t_d, tk, tv = th.hybrid_decode_step(
        tparams, tcfg, t(toks.copy()), t(pos), tk, tv,
        *map(t, (tables, slot_pages, (pos % TP).astype(np.int32), pos + 1)))
    np.testing.assert_allclose(t_d.numpy(), jd, atol=1e-4, rtol=0)
    # the verify step, continuing from the decode's pools
    t_v, tk, tv = th.hybrid_verify_step(tparams, tcfg, t(vtokens), t(vpos.astype(np.int32)),
                                        tk, tv, t(tables), *map(t, vrest))
    np.testing.assert_allclose(t_v.numpy(), jvl, atol=1e-4, rtol=0)
    pad[slot_pages, pos[None]] = False  # the decode's written slots
    pad[vslots, vpos[None]] = False  # the verify's
    _close_pools(tk, jk2, pad)
    _close_pools(tv, jv2, pad)
