"""Llama-family decoder (MHA/GQA + RoPE + SwiGLU) over the paged KV pool.

Port of ``kvcached_tpu/models/llama.py``.  The parameters live in an
``nn.Module`` (:class:`LlamaModel`) with every layer weight **stacked** on a
leading layer axis, as in the JAX package's pytree, so the two packages'
parameters map one to one.  The forward passes are plain functions over
that module; the ``lax.scan`` over layers becomes a Python loop.  The pools
are updated in place by the kernels (the JAX package threaded them through
the scan and donated them).

The projections, MLP and LM head are ``torch.matmul``, as the JAX package
left them to XLA; the attention goes through the hand-written kernels of
:mod:`kvcached_tpu_torch.ops`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device.pool import resolve_device, torch_dtype
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


@dataclass(frozen=True)
class LlamaConfig:
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
    #: Mistral-style sliding-window attention (tokens); None = full attention.
    sliding_window: int | None = None
    #: Qwen2-style additive biases on the q/k/v projections.
    attention_bias: bool = False
    #: Qwen3-style per-head RMSNorm on q/k (over head_dim, before rope).
    qk_norm: bool = False
    #: RoPE frequency scaling: ("linear", factor) or ("llama3", factor,
    #: low_freq_factor, high_freq_factor, original_max_position_embeddings).
    rope_scaling: tuple | None = None

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @classmethod
    def toy(cls, **kw):
        base = dict(
            vocab_size=512,
            hidden_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=128,
            intermediate_size=512,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_8b(cls):
        return cls(
            vocab_size=128256,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=14336,
        )

    @classmethod
    def llama31_8b(cls):
        """Llama-3.1-8B: the 3.0 geometry + llama3 long-context rope scaling."""
        return dataclasses.replace(
            cls.llama3_8b(),
            rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0),
        )


class LlamaModel(nn.Module):
    """Layer-stacked Llama parameters.

    ``embed`` [V, E], ``final_norm`` [E], ``lm_head`` [E, V] and
    ``layers[name]`` [L, ...] with the JAX package's names and layouts
    (projections input-major: ``h @ w``).  Weights are frozen."""

    def __init__(self, cfg: LlamaConfig, embed, layers: dict, final_norm, lm_head):
        super().__init__()
        self.cfg = cfg
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.embed = frozen(embed)
        self.layers = nn.ParameterDict({k: frozen(v) for k, v in layers.items()})
        self.final_norm = frozen(final_norm)
        self.lm_head = frozen(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights (views into the stacks, made once: the
        weights are frozen, and a decode step would otherwise slice every
        stack in every layer)."""
        views = self.__dict__.get("_layer_views")
        if views is None:
            views = self.__dict__["_layer_views"] = [
                {k: v[j] for k, v in self.layers.items()}
                for j in range(self.cfg.num_layers)
            ]
        return views[i]


def init_llama_params(
    cfg: LlamaConfig,
    generator: torch.Generator | None = None,
    *,
    seed: int = 0,
    device=None,
) -> LlamaModel:
    """Random-init parameters on ``device`` (default: the card) from a
    ``torch.Generator`` (one on that device, seeded with ``seed`` when none
    is given).  Weights are normal / sqrt(fan_in), drawn one layer at a time
    in float32 and stored in ``cfg.dtype``, so a full-width 8B needs no
    float32 copy of a whole stack."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    E, H, KH, D, F_, L = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.intermediate_size, cfg.num_layers,
    )
    dt = cfg.tdtype

    def init(shape, fan_in, lead=None):
        out = torch.empty(((lead,) if lead else ()) + shape, dtype=dt, device=dev)
        for i in range(lead or 1):
            x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            (out[i] if lead else out).copy_(x.div_(math.sqrt(fan_in)))
        return out

    shapes = {
        "wq": ((E, H * D), E),
        "wk": ((E, KH * D), E),
        "wv": ((E, KH * D), E),
        "wo": ((H * D, E), H * D),
        "w_gate": ((E, F_), E),
        "w_up": ((E, F_), E),
        "w_down": ((F_, E), F_),
    }
    layers = {
        "attn_norm": torch.ones((L, E), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, E), dtype=dt, device=dev),
    }
    for name, (shape, fan_in) in shapes.items():
        layers[name] = init(shape, fan_in, L)
    if cfg.attention_bias:
        layers["bq"] = init((H * D,), H * D, L)
        layers["bk"] = init((KH * D,), KH * D, L)
        layers["bv"] = init((KH * D,), KH * D, L)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, D), dtype=dt, device=dev)
        layers["k_norm"] = torch.ones((L, D), dtype=dt, device=dev)
    return LlamaModel(
        cfg,
        embed=init((cfg.vocab_size, E), E),
        layers=layers,
        final_norm=torch.ones((E,), dtype=dt, device=dev),
        lm_head=init((E, cfg.vocab_size), E),
    )


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_inv_freqs(d: int, theta: float, scaling: tuple | None, device=None) -> torch.Tensor:
    """Inverse frequencies with optional long-context scaling (linear, or
    transformers' llama3 band blend)."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if scaling is None:
        return freqs
    kind = scaling[0]
    if kind == "linear":
        return freqs / scaling[1]
    if kind == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        blended = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(
            wavelen > orig / low_f, freqs / factor,
            torch.where(wavelen < orig / high_f, freqs, blended),
        )
    raise ValueError(f"unsupported rope scaling {kind!r}")


def rope_cos_sin(positions: torch.Tensor, d: int, theta: float,
                 scaling: tuple | None = None):
    """cos/sin tables for positions [..., T] → [..., T, 1, d/2] each (the
    1 broadcasts over heads).  Computed once per step, shared by layers."""
    freqs = rope_inv_freqs(d, theta, scaling, positions.device)
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: tuple | None = None) -> torch.Tensor:
    """Rotary embedding. x: [..., T, heads, head_dim], positions: [..., T]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling)
    return apply_rope(x, cos, sin)


def qkv_proj(h: torch.Tensor, lp: dict):
    """q/k/v projections, flat on the last axis, plus Qwen2 biases when the
    layer carries them."""
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def qkv_heads(h: torch.Tensor, lp: dict, H: int, KH: int, D: int, eps: float):
    """Per-head q/k/v, pre-rope: projection, head split, and the Qwen3
    per-head RMSNorm on q/k when the layer carries ``q_norm``/``k_norm``."""
    q, k, v = qkv_proj(h, lp)
    lead = h.shape[:-1]
    q = q.reshape(*lead, H, D)
    k = k.reshape(*lead, KH, D)
    v = v.reshape(*lead, KH, D)
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], eps)
        k = rms_norm(k, lp["k_norm"], eps)
    return q, k, v


def lm_head_logits(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    return (x @ lm_head).float()


def _mlp(x, lp, eps):
    h = rms_norm(x, lp["mlp_norm"], eps)
    return x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _heads(params: LlamaModel, cfg: LlamaConfig):
    D = cfg.head_dim
    return params.layers["wq"].shape[-1] // D, params.layers["wk"].shape[-1] // D, D


def _kernel_inputs(pool_dtype, quant_scales):
    """(cast for q and the new K/V, int8 scales kwargs) of a pool: float32
    and bf16 pools take their own type; byte pools take q and the K/V
    unquantized (the kernels quantize on write), and int8 pools their
    ``quant_scales`` = (k_scales, v_scales) [L, KH] float32."""
    if pool_dtype not in BYTE_DTYPES:
        return (lambda t: t.to(pool_dtype)), {}
    if quant_scales is None:
        return (lambda t: t), {}
    return (lambda t: t), dict(k_scales=quant_scales[0], v_scales=quant_scales[1])


def llama_decode_step(
    params: LlamaModel,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int (0-based index of this token)
    k_pools: torch.Tensor,  # [L, num_pages, KH, page_tokens, D]
    v_pools: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int32 PHYSICAL page ids
    slot_pages: torch.Tensor,  # [B] int32 physical page for this token
    slot_offsets: torch.Tensor,  # [B] int32 slot within that page
    seq_lens: torch.Tensor,  # [B] int32 length INCLUDING this token
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """One decode token for each of B sequences.  Returns (logits [B, V]
    float32, k_pools, v_pools); the pools are written in place.

    int8 pools: pass ``quant_scales`` = (k_scales, v_scales), each [L, KH]
    float32; the K/V reach the kernel unquantized and are quantized there.

    ``reference_attention`` runs the kernels' plain PyTorch versions
    instead of the kernels, on whatever device the tensors are: the on-card
    reference the kernel path is checked against.  Serving never sets it."""
    decode = paged_attention_decode_plain if reference_attention else paged_attention_decode
    B = tokens.shape[0]
    H, KH, D = _heads(params, cfg)
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.rope_scaling)
    x = params.embed[tokens]  # [B, E]
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # fused kernel: write this token's K/V into its page, then attend
        # over everything incl. itself
        attn, _, _ = decode(
            cast(q), k_pools, v_pools, page_tables, seq_lens, i,
            cast(k), cast(v), slot_pages, slot_offsets,
            window=cfg.sliding_window, **scales,
        )
        x = x + attn.to(x.dtype).reshape(B, H * D) @ lp["wo"]
        x = _mlp(x, lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return lm_head_logits(x, params.lm_head), k_pools, v_pools


def llama_verify_step(
    params: LlamaModel,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] int: [last_token, draft_1 .. draft_{T-1}]
    positions: torch.Tensor,  # [B, T] int
    k_pools: torch.Tensor,
    v_pools: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int32 PHYSICAL page ids
    slot_pages: torch.Tensor,  # [B, T] int32 write page per fed token (0 = discard)
    slot_offsets: torch.Tensor,  # [B, T] int32
    seq_lens: torch.Tensor,  # [B] int32 length INCLUDING all T fed tokens
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Speculative-decode verification: T tokens per sequence in one
    forward pass (the weights stream once for T tokens), writing their K/V
    and returning the logits at every position.  Returns (logits [B, T, V]
    float32, k_pools, v_pools); the pools are written in place.
    ``quant_scales`` and ``reference_attention`` as in
    :func:`llama_decode_step`."""
    verify = paged_attention_verify_plain if reference_attention else paged_attention_verify
    B, T = tokens.shape
    H, KH, D = _heads(params, cfg)
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.rope_scaling)
    x = params.embed[tokens]  # [B, T, E]
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn, _, _ = verify(
            cast(q), k_pools, v_pools, page_tables, seq_lens, i,
            cast(k), cast(v), slot_pages, slot_offsets,
            window=cfg.sliding_window, **scales,
        )  # [B, T, H, D]
        x = x + attn.to(x.dtype).reshape(B, T, H * D) @ lp["wo"]
        x = _mlp(x, lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return lm_head_logits(x, params.lm_head), k_pools, v_pools


def llama_prefill_batch_step(
    params: LlamaModel,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, T] int: N chunks padded to a shared bucket
    positions: torch.Tensor,  # [N, T] int = q_starts[:, None] + arange(T)
    k_pools: torch.Tensor,
    v_pools: torch.Tensor,
    chunk_pages: torch.Tensor,  # [N, T // page_tokens] int32 (0 = discard)
    page_tables: torch.Tensor,  # [N, max_pages] int32 full-sequence pages
    q_starts: torch.Tensor,  # [N] int32 global position of tokens[:, 0]
    true_lens: torch.Tensor,  # [N] int32 real new tokens per row (0 = pad row)
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Prefill N sequences' chunks in one forward pass.  Each row writes
    its chunk through its own ``chunk_pages`` and attends with its own
    (q_start, true_len), so the result is identical to N serial
    :func:`llama_prefill_step` calls.  Returns (logits at each row's last
    real token [N, V] float32, k_pools, v_pools).  ``quant_scales`` as in
    :func:`llama_decode_step` (the page writer takes each layer's row)."""
    if reference_attention:
        write, attend = write_prefill_kv_plain, paged_prefill_attention_batch_plain
    else:
        write, attend = write_prefill_kv, paged_prefill_attention_batch
    N, T = tokens.shape
    H, KH, D = _heads(params, cfg)
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    q_starts = q_starts.to(torch.int32)
    true_lens = true_lens.to(torch.int32)
    kv_lens = q_starts + true_lens
    flat_pages = chunk_pages.reshape(-1).to(torch.int32).contiguous()
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.rope_scaling)
    x = params.embed[tokens]  # [N, T, E]
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_heads(h, lp, H, KH, D, cfg.rms_eps)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # page writes don't care which sequence a page belongs to: flatten
        # the batch into one [KH, N*T, D] stream over N*T/P pages
        write(
            k_pools, v_pools,
            cast(k).permute(2, 0, 1, 3).reshape(KH, N * T, D),
            cast(v).permute(2, 0, 1, 3).reshape(KH, N * T, D),
            flat_pages, i,
            **({"k_scale": quant_scales[0][i], "v_scale": quant_scales[1][i]}
               if scales else {}),
        )
        attn = attend(
            cast(q), k_pools, v_pools, page_tables, q_starts, kv_lens, i,
            window=cfg.sliding_window, **scales,
        )  # [N, T, H, D]
        x = x + attn.to(x.dtype).reshape(N, T, H * D) @ lp["wo"]
        x = _mlp(x, lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    last_idx = (true_lens.long() - 1).clamp(min=0)
    last = x[torch.arange(N, device=x.device), last_idx]  # [N, E]
    return lm_head_logits(last, params.lm_head), k_pools, v_pools


def llama_prefill_step(
    params: LlamaModel,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [T] int: the new chunk, padded; T % page_tokens == 0
    positions: torch.Tensor,  # [T] int = q_start + arange(T)
    k_pools: torch.Tensor,
    v_pools: torch.Tensor,
    chunk_pages: torch.Tensor,  # [T // page_tokens] int32
    page_table: torch.Tensor,  # [max_pages] int32: full sequence pages
    q_start,  # global position of tokens[0] (page-aligned)
    true_len,  # real new tokens in the chunk
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Prefill one chunk of one sequence: write its K/V into its pages, then
    causal paged attention over the sequence so far (cached prefix + this
    chunk).  The N=1 view of :func:`llama_prefill_batch_step`.  Returns
    (logits_last [V] float32, k_pools, v_pools)."""
    dev = tokens.device
    as_row = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(1)  # noqa: E731
    logits, k_pools, v_pools = llama_prefill_batch_step(
        params, cfg, tokens[None], positions[None], k_pools, v_pools,
        chunk_pages[None], page_table[None], as_row(q_start), as_row(true_len),
        quant_scales=quant_scales, reference_attention=reference_attention,
    )
    return logits[0], k_pools, v_pools
