"""Hybrid-attention decoder: full-attention and sliding-window layer groups
over one shared paged arena (the Gemma2 family).

Port of ``kvcached_tpu/models/hybrid.py`` for groups of equal layer count.
Each distinct window is a layer group; group ``g``'s layers are the arena
layers ``0 .. layers_per_group - 1`` of one pool ``[L_g, pages, KH, P, D]``
whose pages every group shares (one free list), while each group keeps its
own page table (``page_tables[g]``) and write slots (``slot_pages[g]``).
The residual stream passes through the layers in their model order; only
the KV bookkeeping is grouped.  Where the JAX package dispatched each
layer's attention through ``lax.switch`` over per-group branches, the port
runs a Python loop over layers and reads each layer's group, arena layer and
window from the config.

The Gemma2 knobs: a tanh-approximated GELU MLP, ``(1 + w)`` RMSNorm
weights, embeddings scaled by ``sqrt(hidden)`` (rounded to the parameters'
type first), post-attention and post-feedforward norms on the residual
branches, ``sm_scale = query_pre_attn_scalar ** -0.5``, and logit
soft-capping of the attention scores (inside K1, K3 and K4,
``logit_softcap``) and of the final logits.

The arena may hold int8 or float8_e4m3fn pages, as the Llama family's
pools may: int8 scales come per model layer, ``[num_layers, KH]``, and
each group's layers take their rows (:func:`_group_scales`).  The verify
step (:func:`hybrid_verify_step`) serves speculative decoding.

Not ported yet (ROADMAP A11b): unequal groups on per-group arenas.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device.pool import torch_dtype
from ..ops.paged_attention import (
    BYTE_DTYPES,
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_verify,
    paged_attention_verify_plain,
    write_prefill_kv,
    write_prefill_kv_plain,
)
from ..ops.paged_prefill import (
    paged_prefill_attention_batch,
    paged_prefill_attention_batch_plain,
)
from .llama import (
    KVCollector,
    LlamaModel,
    _heads,
    _kernel_inputs,
    apply_rope,
    init_llama_params,
    lm_head_logits,
    qkv_heads,
    rms_norm,
    rope_cos_sin,
)


@dataclass(frozen=True)
class HybridConfig:
    """Llama-shaped decoder with per-layer attention windows."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 5632
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    #: per-layer window: None = full attention, int = sliding window tokens.
    layer_windows: tuple = ()
    #: MLP activation: "silu" (Llama) or "gelu_tanh" (Gemma's gelu_pytorch_tanh)
    act: str = "silu"
    #: RMSNorm weight convention: effective weight = 1 + stored weight (Gemma)
    norm_offset: bool = False
    #: scale embeddings by sqrt(hidden_size) after lookup (Gemma)
    embed_scale: bool = False
    #: post-attention and post-feedforward RMSNorms on the residual branches
    #: (Gemma2/3: ``post_attn_norm`` / ``post_ffw_norm``)
    post_norms: bool = False
    #: attention logit soft-capping cap * tanh(score / cap) inside the paged
    #: kernels, before the mask (Gemma2's attn_logit_softcapping)
    attn_softcap: float | None = None
    #: final LM-head logit soft-capping (Gemma2's final_logit_softcapping)
    final_softcap: float | None = None
    #: softmax scale = query_scale ** -0.5 when set (Gemma2's
    #: query_pre_attn_scalar; None = 1 / sqrt(head_dim))
    query_scale: float | None = None
    #: Qwen3/Gemma3-style per-head q/k RMSNorm
    qk_norm: bool = False
    #: Qwen2-style additive qkv biases
    attention_bias: bool = False
    #: RoPE frequency scaling, as in LlamaConfig
    rope_scaling: tuple | None = None
    #: Gemma3-class per-group RoPE: sliding-window layers use this base
    #: frequency unscaled, full-attention layers rope_theta + rope_scaling;
    #: None = all layers share rope_theta / rope_scaling
    local_rope_theta: float | None = None

    def __post_init__(self):
        if len(self.layer_windows) != self.num_layers:
            raise ValueError(
                f"layer_windows must have {self.num_layers} entries, got "
                f"{len(self.layer_windows)}")

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @classmethod
    def toy(cls, num_layers: int = 4, window: int = 32, **kw):
        """Alternating full / sliding-window layers (the gpt-oss pattern)."""
        base = dict(
            vocab_size=512,
            hidden_size=256,
            num_layers=num_layers,
            num_heads=4,
            num_kv_heads=2,
            head_dim=128,
            intermediate_size=512,
            layer_windows=tuple(None if i % 2 == 0 else window for i in range(num_layers)),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def gemma2_27b(cls, **kw):
        """Gemma-2-27B's widths, from its published ``config.json``
        (google/gemma-2-27b): 46 layers, hidden 4608, 32 query heads, 16 kv
        heads of head_dim 128, FFN 36864, vocab 256000, query_pre_attn_scalar
        144, sliding_window 4096, attn_logit_softcapping 50.0,
        final_logit_softcapping 30.0, rms_norm_eps 1e-6, rope_theta 10000,
        gelu_pytorch_tanh.  Even layers slide, as transformers' Gemma2 layers
        do, so the two groups (sliding, full) hold 23 layers each.  The LM
        head is a matrix of its own (the checkpoint ties it to the
        embedding): about 28.4 B parameters."""
        L = kw.pop("num_layers", 46)
        base = dict(
            vocab_size=256000,
            hidden_size=4608,
            num_layers=L,
            num_heads=32,
            num_kv_heads=16,
            head_dim=128,
            intermediate_size=36864,
            rope_theta=10000.0,
            rms_eps=1e-6,
            layer_windows=tuple(4096 if i % 2 == 0 else None for i in range(L)),
            act="gelu_tanh",
            norm_offset=True,
            embed_scale=True,
            post_norms=True,
            attn_softcap=50.0,
            final_softcap=30.0,
            query_scale=144.0,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def gemma2_9b(cls, **kw):
        """Gemma-2-9B's widths, from its published ``config.json``
        (google/gemma-2-9b): 42 layers, hidden 3584, 16 query heads and 8
        kv heads of head_dim 256 (a query width of 4096, not the hidden
        size), FFN 14336, vocab 256000, query_pre_attn_scalar 256,
        sliding_window 4096, attn_logit_softcapping 50.0,
        final_logit_softcapping 30.0, rms_norm_eps 1e-6, rope_theta 10000,
        gelu_pytorch_tanh.  Even layers slide, so the two groups hold 21
        layers each.  The LM head is a matrix of its own (the checkpoint
        ties it to the embedding): about 10.2 B parameters."""
        L = kw.pop("num_layers", 42)
        base = dict(
            vocab_size=256000,
            hidden_size=3584,
            num_layers=L,
            num_heads=16,
            num_kv_heads=8,
            head_dim=256,
            intermediate_size=14336,
            rope_theta=10000.0,
            rms_eps=1e-6,
            layer_windows=tuple(4096 if i % 2 == 0 else None for i in range(L)),
            act="gelu_tanh",
            norm_offset=True,
            embed_scale=True,
            post_norms=True,
            attn_softcap=50.0,
            final_softcap=30.0,
            query_scale=256.0,
        )
        base.update(kw)
        return cls(**base)

    # ---- group structure ---------------------------------------------------

    @property
    def group_windows(self) -> tuple:
        """Distinct windows in order of first appearance (group g's window)."""
        seen: list = []
        for w in self.layer_windows:
            if w not in seen:
                seen.append(w)
        return tuple(seen)

    @property
    def group_index(self) -> tuple:
        """Group id of each layer."""
        gw = self.group_windows
        return tuple(gw.index(w) for w in self.layer_windows)

    @property
    def layer_in_group(self) -> tuple:
        """Arena layer index of each layer (position within its group)."""
        counts = [0] * len(self.group_windows)
        out = []
        for g in self.group_index:
            out.append(counts[g])
            counts[g] += 1
        return tuple(out)

    @property
    def group_layer_counts(self) -> tuple:
        """Layers per group, in group order."""
        gi = self.group_index
        return tuple(gi.count(g) for g in range(len(self.group_windows)))

    @property
    def equal_groups(self) -> bool:
        return len(set(self.group_layer_counts)) <= 1

    @property
    def layers_per_group(self) -> int:
        counts = self.group_layer_counts
        if len(set(counts)) != 1:
            raise ValueError(
                f"groups must have equal layer counts to share one arena, "
                f"got {counts}; unequal groups use per-group arenas "
                f"(engine allocates one pool per group)")
        return counts[0]

    def rope_for_group(self, g: int) -> tuple:
        """(theta, scaling) of group g's layers: with ``local_rope_theta``
        set, sliding-window groups use it unscaled; otherwise every group
        uses rope_theta + rope_scaling."""
        if self.local_rope_theta is not None and self.group_windows[g] is not None:
            return self.local_rope_theta, None
        return self.rope_theta, self.rope_scaling


class HybridModel(LlamaModel):
    """Layer-stacked hybrid parameters: :class:`LlamaModel`'s container with
    the Gemma extras ``post_attn_norm`` / ``post_ffw_norm`` among the layer
    stacks when ``post_norms`` is set.  Weights are frozen."""


def init_hybrid_params(
    cfg: HybridConfig,
    generator: torch.Generator | None = None,
    *,
    seed: int = 0,
    device=None,
) -> HybridModel:
    """Random-init parameters on ``device`` (default: the card): the Llama
    family's (:func:`init_llama_params`, drawn one layer at a time) plus the
    post norms; under ``norm_offset`` every norm but q/k's is stored as
    zeros, an effective weight of one, as the JAX package stores them."""
    p = init_llama_params(cfg, generator, seed=seed, device=device)
    layers = {k: v.data for k, v in p.layers.items()}
    final_norm = p.final_norm.data
    L, E = cfg.num_layers, cfg.hidden_size
    if cfg.post_norms:
        for name in ("post_attn_norm", "post_ffw_norm"):
            layers[name] = torch.ones((L, E), dtype=cfg.tdtype, device=final_norm.device)
    if cfg.norm_offset:
        for name in layers:
            if name.endswith("norm") and name not in ("q_norm", "k_norm"):
                layers[name].zero_()
        final_norm.zero_()
    return HybridModel(cfg, p.embed.data, layers, final_norm, p.lm_head.data)


def _norm(x, w, cfg):
    return rms_norm(x, (1.0 + w) if cfg.norm_offset else w, cfg.rms_eps)


def _embed(params, tokens, cfg):
    x = params.embed[tokens]
    if cfg.embed_scale:
        # sqrt(hidden) in the parameters' type first (68.0, not 67.88, at bf16)
        x = x * float(torch.tensor(math.sqrt(cfg.hidden_size)).to(x.dtype))
    return x


def _sm_scale(cfg):
    return None if cfg.query_scale is None else cfg.query_scale ** -0.5


def _attn_residual(x, attn_flat, lp, cfg):
    """wo projection, with the post-attention norm on the branch."""
    out = attn_flat.to(x.dtype) @ lp["wo"]
    if cfg.post_norms:
        out = _norm(out, lp["post_attn_norm"], cfg)
    return x + out


def _mlp_residual(x, lp, cfg):
    h = _norm(x, lp["mlp_norm"], cfg)
    gate = h @ lp["w_gate"]
    act = F.gelu(gate, approximate="tanh") if cfg.act == "gelu_tanh" else F.silu(gate)
    mlp = (act * (h @ lp["w_up"])) @ lp["w_down"]
    if cfg.post_norms:
        mlp = _norm(mlp, lp["post_ffw_norm"], cfg)
    return x + mlp


def _cap_logits(logits, cfg):
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _final_logits(x, params, cfg):
    x = _norm(x, params.final_norm, cfg)
    return _cap_logits(lm_head_logits(x, params.lm_head), cfg)


def _check_pools(k_pools):
    """The ported form: one shared arena (of any pool type)."""
    if isinstance(k_pools, (tuple, list)):
        raise NotImplementedError(
            "per-group arenas (unequal layer groups) are not ported yet (ROADMAP A11b)")


def _group_scales(cfg, k_pools, quant_scales):
    """The attention kernels' int8 scale keywords of each group: the
    per-model-layer scales (k, v), ``[num_layers, KH]`` each, split into
    the group's arena-shaped ``[L_g, KH]`` (its layers in model order are
    its arena layers, so a gather per group is exact; the reference's
    ``_group_scales``).  Empty for pools without scales."""
    G = len(cfg.group_windows)
    if quant_scales is None or k_pools.dtype not in BYTE_DTYPES:
        return [{}] * G
    ks, vs = quant_scales
    if tuple(ks.shape[:1]) != (cfg.num_layers,) or ks.shape != vs.shape:
        raise ValueError(
            f"layer groups take int8 scales per model layer, [{cfg.num_layers}, KH]; "
            f"got k={tuple(ks.shape)} v={tuple(vs.shape)}")
    out = []
    for g in range(G):
        sel = torch.tensor([i for i, gx in enumerate(cfg.group_index) if gx == g],
                           device=ks.device)
        out.append(dict(k_scales=ks[sel], v_scales=vs[sel]))
    return out


def _group_ropes(cfg, positions, D):
    """cos/sin tables of each group's rope, computed once per step."""
    tables = {}
    out = []
    for g in range(len(cfg.group_windows)):
        key = cfg.rope_for_group(g)
        if key not in tables:
            tables[key] = rope_cos_sin(positions, D, *key)
        out.append(tables[key])
    return out


def _layers(cfg):
    """(layer, group, arena layer, window) of each model layer, in order."""
    windows = cfg.group_windows
    return [(i, g, lg, windows[g]) for i, (g, lg) in
            enumerate(zip(cfg.group_index, cfg.layer_in_group))]


def hybrid_decode_step(
    params: HybridModel,
    cfg: HybridConfig,
    tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int
    k_pools: torch.Tensor,  # [L_g, num_pages, KH, page_tokens, D] shared arena
    v_pools: torch.Tensor,
    page_tables: torch.Tensor,  # [G, B, max_pages] int32 PHYSICAL ids per group
    slot_pages: torch.Tensor,  # [G, B] int32 write page per group (0 = discard)
    slot_offsets: torch.Tensor,  # [B] int32
    seq_lens: torch.Tensor,  # [B] int32 INCLUDING this token
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
    collect_kv: bool = False,
):
    """One decode token for each of B sequences: each layer writes its
    token into arena layer ``layer_in_group[l]`` through its group's slot
    and attends over its group's pages with the group's window and the
    attention soft-cap (K1).  Returns (logits [B, V] float32, k_pools,
    v_pools); the pools are written in place.  Byte pools: ``quant_scales``
    = (k_scales, v_scales), each ``[num_layers, KH]`` per model layer
    (int8); ``reference_attention`` and ``collect_kv`` (``(ks, vs)``
    ``[num_layers, B, KH, D]``, by model layer) as in
    :func:`~kvcached_tpu_torch.models.llama.llama_decode_step`."""
    _check_pools(k_pools)
    decode = paged_attention_decode_plain if reference_attention else paged_attention_decode
    B = tokens.shape[0]
    H, KH, D = _heads(params, cfg)
    cast, _ = _kernel_inputs(k_pools.dtype, None)
    scales = _group_scales(cfg, k_pools, quant_scales)
    ropes = _group_ropes(cfg, positions, D)
    x = _embed(params, tokens, cfg)  # [B, E]
    kv = KVCollector(collect_kv)
    for i, g, lg, window in _layers(cfg):
        lp = params.layer(i)
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, *ropes[g]), apply_rope(k, *ropes[g])
        attn, _, _ = decode(
            cast(q), k_pools, v_pools, page_tables[g], seq_lens, lg,
            *kv(cast(k), cast(v)), slot_pages[g], slot_offsets,
            window=window, sm_scale=_sm_scale(cfg), logit_softcap=cfg.attn_softcap,
            **scales[g],
        )
        x = _attn_residual(x, attn.reshape(B, H * D), lp, cfg)
        x = _mlp_residual(x, lp, cfg)
    return kv.result(_final_logits(x, params, cfg), k_pools, v_pools)


def hybrid_prefill_batch_step(
    params: HybridModel,
    cfg: HybridConfig,
    tokens: torch.Tensor,  # [N, T] int: N chunks padded to a shared bucket
    positions: torch.Tensor,  # [N, T] int
    k_pools: torch.Tensor,
    v_pools: torch.Tensor,
    chunk_pages: torch.Tensor,  # [N, G, T // page_tokens] int32 (0 = discard)
    page_tables: torch.Tensor,  # [N, G, max_pages] int32
    q_starts: torch.Tensor,  # [N] int32
    true_lens: torch.Tensor,  # [N] int32 (0 = pad row)
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Prefill N sequences' chunks in one pass: each layer writes its chunk
    through its group's page row (K2) and attends with its group's window
    and the soft-cap (K3); identical to N serial :func:`hybrid_prefill_step`
    calls.  Returns (logits at each row's last real token [N, V] float32,
    k_pools, v_pools).  ``quant_scales`` as in :func:`hybrid_decode_step`
    (the page writer takes each model layer's row)."""
    _check_pools(k_pools)
    if reference_attention:
        write, attend = write_prefill_kv_plain, paged_prefill_attention_batch_plain
    else:
        write, attend = write_prefill_kv, paged_prefill_attention_batch
    N, T = tokens.shape
    H, KH, D = _heads(params, cfg)
    cast, _ = _kernel_inputs(k_pools.dtype, None)
    scales = _group_scales(cfg, k_pools, quant_scales)
    q_starts = q_starts.to(torch.int32)
    true_lens = true_lens.to(torch.int32)
    kv_lens = q_starts + true_lens
    G = len(cfg.group_windows)
    # each group's pages: the batch flattened into one write stream, and
    # the rows' tables
    flat_pages = [chunk_pages[:, g].reshape(-1).to(torch.int32).contiguous() for g in range(G)]
    tables = [page_tables[:, g].contiguous() for g in range(G)]
    ropes = _group_ropes(cfg, positions, D)
    x = _embed(params, tokens, cfg)  # [N, T, E]
    for i, g, lg, window in _layers(cfg):
        lp = params.layer(i)
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, *ropes[g]), apply_rope(k, *ropes[g])
        write(
            k_pools, v_pools,
            cast(k).permute(2, 0, 1, 3).reshape(KH, N * T, D),
            cast(v).permute(2, 0, 1, 3).reshape(KH, N * T, D),
            flat_pages[g], lg,
            **({"k_scale": quant_scales[0][i], "v_scale": quant_scales[1][i]}
               if scales[g] else {}),
        )
        attn = attend(
            cast(q), k_pools, v_pools, tables[g], q_starts, kv_lens, lg,
            window=window, sm_scale=_sm_scale(cfg), logit_softcap=cfg.attn_softcap,
            **scales[g],
        )  # [N, T, H, D]
        x = _attn_residual(x, attn.reshape(N, T, H * D), lp, cfg)
        x = _mlp_residual(x, lp, cfg)
    x = _norm(x, params.final_norm, cfg)
    last = x[torch.arange(N, device=x.device), (true_lens.long() - 1).clamp(min=0)]
    return _cap_logits(lm_head_logits(last, params.lm_head), cfg), k_pools, v_pools


def hybrid_prefill_step(
    params: HybridModel,
    cfg: HybridConfig,
    tokens: torch.Tensor,  # [T] int
    positions: torch.Tensor,  # [T] int
    k_pools: torch.Tensor,
    v_pools: torch.Tensor,
    chunk_pages: torch.Tensor,  # [G, T // page_tokens] int32 per-group write pages
    page_table: torch.Tensor,  # [G, max_pages] int32
    q_start,
    true_len,
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Prefill one chunk of one sequence: the N=1 view of
    :func:`hybrid_prefill_batch_step`.  Returns (logits_last [V] float32,
    k_pools, v_pools)."""
    dev = tokens.device
    as_row = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(1)  # noqa: E731
    logits, k_pools, v_pools = hybrid_prefill_batch_step(
        params, cfg, tokens[None], positions[None], k_pools, v_pools,
        chunk_pages[None], page_table[None], as_row(q_start), as_row(true_len),
        quant_scales=quant_scales, reference_attention=reference_attention,
    )
    return logits[0], k_pools, v_pools


def hybrid_verify_step(
    params: HybridModel,
    cfg: HybridConfig,
    tokens: torch.Tensor,  # [B, T] int: [last_token, draft_1 .. draft_{T-1}]
    positions: torch.Tensor,  # [B, T] int
    k_pools: torch.Tensor,  # [L_g, num_pages, KH, page_tokens, D] shared arena
    v_pools: torch.Tensor,
    page_tables: torch.Tensor,  # [G, B, max_pages] int32 PHYSICAL ids per group
    slot_pages: torch.Tensor,  # [G, B, T] int32 write page per group (0 = discard)
    slot_offsets: torch.Tensor,  # [B, T] int32
    seq_lens: torch.Tensor,  # [B] int32 INCLUDING all T fed tokens
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
    collect_kv: bool = False,
):
    """Speculative-decode verification on layer groups: each layer writes
    the T fed tokens into arena layer ``layer_in_group[l]`` through its
    group's slots and verifies them over its group's pages with the
    group's window and the attention soft-cap (K4); full-attention and
    sliding groups alike.  Returns (logits [B, T, V] float32, k_pools,
    v_pools); the pools are written in place.  ``quant_scales``,
    ``reference_attention`` and ``collect_kv`` (``[num_layers, B, T, KH,
    D]`` each) as in :func:`hybrid_decode_step`."""
    _check_pools(k_pools)
    verify = paged_attention_verify_plain if reference_attention else paged_attention_verify
    B, T = tokens.shape
    H, KH, D = _heads(params, cfg)
    cast, _ = _kernel_inputs(k_pools.dtype, None)
    scales = _group_scales(cfg, k_pools, quant_scales)
    ropes = _group_ropes(cfg, positions, D)
    x = _embed(params, tokens, cfg)  # [B, T, E]
    kv = KVCollector(collect_kv)
    for i, g, lg, window in _layers(cfg):
        lp = params.layer(i)
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, *ropes[g]), apply_rope(k, *ropes[g])
        attn, _, _ = verify(
            cast(q), k_pools, v_pools, page_tables[g], seq_lens, lg,
            *kv(cast(k), cast(v)), slot_pages[g], slot_offsets,
            window=window, sm_scale=_sm_scale(cfg), logit_softcap=cfg.attn_softcap,
            **scales[g],
        )  # [B, T, H, D]
        x = _attn_residual(x, attn.reshape(B, T, H * D), lp, cfg)
        x = _mlp_residual(x, lp, cfg)
    return kv.result(_final_logits(x, params, cfg), k_pools, v_pools)
