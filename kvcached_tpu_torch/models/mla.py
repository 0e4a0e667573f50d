"""MLA (multi-head latent attention) family, DeepSeek-V2 style, over the
single latent pool.

Port of ``kvcached_tpu/models/mla.py``.  The cache stores one entry a token,
``rms_norm(c_kv)`` (``kv_lora_rank`` lanes) ++ the shared rope key, padded
to a 128-lane multiple: the ``num_kv_buffers = 1`` pool.  Attention runs in
the absorbed form

    score_h(t) = (W_UK[h]^T q_nope_h) . c_t  +  q_rope_h . k_rope_t
    out_h      = W_UV[h]^T (sum_t p_t c_t)

so the kernels see one shared kv head of ``cache_head_dim`` lanes whose
values are its first ``kv_lora_rank`` lanes: the MLA mode of
:mod:`kvcached_tpu_torch.ops` (K5 for decode and verify, K6 and K3m for
prefill).  The parameters live in :class:`MLAModel`, stacked on a leading
layer axis under the JAX package's names; the forward passes are plain
functions over it with a Python loop over layers.  The projections, the
absorb and out-projection einsums (in float32, as the JAX package does them)
and the MLP are ``torch.matmul``.

Byte latent pools (int8, float8_e4m3fn) take the queries and entries in
the model's type, unquantized: the kernels quantize what they write, and
an int8 pool's ``quant_scales`` = (k_scales, v_scales) [L, 1] give one
scale a layer, whose K scale serves the values too (they are lanes of the
same entries), as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device.pool import resolve_device, torch_dtype
from ..ops.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_verify,
    paged_attention_verify_plain,
    write_prefill_kv_single,
    write_prefill_kv_single_plain,
)
from ..ops.paged_prefill import (
    paged_prefill_attention_batch,
    paged_prefill_attention_batch_plain,
)
from .llama import (
    KVCollector,
    LlamaModel,
    _kernel_inputs,
    _mlp,
    apply_rope,
    lm_head_logits,
    rms_norm,
    rope_cos_sin,
)


def _pad128(x: int) -> int:
    return (x + 127) // 128 * 128


@dataclass(frozen=True)
class MLAConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int | None = None  # None = direct q projection
    intermediate_size: int = 5632
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def latent_dim(self) -> int:
        """Unpadded cache entry: c_kv ++ k_rope."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def cache_head_dim(self) -> int:
        """Pool head_dim: the latent padded to a 128-lane multiple."""
        return _pad128(self.latent_dim)

    @property
    def sm_scale(self) -> float:
        return 1.0 / math.sqrt(self.qk_nope_head_dim + self.qk_rope_head_dim)

    # kv geometry for the engine and the pool
    @property
    def num_kv_heads(self) -> int:
        return 1

    @property
    def head_dim(self) -> int:
        return self.cache_head_dim

    @property
    def num_kv_buffers(self) -> int:
        return 1

    @classmethod
    def toy(cls, **kw):
        base = dict(
            vocab_size=512,
            hidden_size=256,
            num_layers=2,
            num_heads=4,
            kv_lora_rank=128,
            qk_nope_head_dim=64,
            qk_rope_head_dim=64,
            v_head_dim=64,
            intermediate_size=512,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def deepseek_v2_lite(cls, **kw):
        """DeepSeek-V2-Lite's attention widths, from its published
        ``config.json`` (deepseek-ai/DeepSeek-V2-Lite; arXiv 2405.04434):
        hidden 2048, 27 layers, 16 heads, kv_lora_rank 512, qk_nope 128,
        qk_rope 64, v_head 128, no q-LoRA, vocab 102400, rope_theta 10000,
        rms_norm_eps 1e-6.  Cut to what this family has: every layer's MLP
        is the dense SwiGLU of V2-Lite's first layer (intermediate 10944)
        instead of its MoE (64 routed + 2 shared experts, top-6), and the
        rope is plain (no YaRN scaling).  About 2.61 B parameters."""
        base = dict(
            vocab_size=102400,
            hidden_size=2048,
            num_layers=27,
            num_heads=16,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            intermediate_size=10944,
            rope_theta=10000.0,
            rms_eps=1e-6,
        )
        base.update(kw)
        return cls(**base)


class MLAModel(LlamaModel):
    """Layer-stacked MLA parameters: ``embed`` [V, E], ``final_norm`` [E],
    ``lm_head`` [E, V] and ``layers[name]`` [L, ...] under the JAX
    package's names (``wq, w_dkv, w_kr, kv_norm, w_uk, w_uv, wo,
    attn_norm, mlp_norm, w_gate, w_up, w_down``).  The container is
    :class:`LlamaModel`'s; weights are frozen."""


def init_mla_params(
    cfg: MLAConfig,
    generator: torch.Generator | None = None,
    *,
    seed: int = 0,
    device=None,
) -> MLAModel:
    """Random-init parameters on ``device`` (default: the card) from a
    ``torch.Generator`` (one on that device, seeded with ``seed`` when none
    is given): normal / sqrt(fan_in), norms ones, as the JAX package's
    ``init_mla_params`` draws them.  Drawn one layer at a time in float32
    and stored in ``cfg.dtype``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    E, H, L = cfg.hidden_size, cfg.num_heads, cfg.num_layers
    R, NP, RP, V = (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.v_head_dim)
    F_ = cfg.intermediate_size
    dt = cfg.tdtype

    def init(shape, fan_in, lead=None):
        out = torch.empty(((lead,) if lead else ()) + shape, dtype=dt, device=dev)
        for i in range(lead or 1):
            x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            (out[i] if lead else out).copy_(x.div_(math.sqrt(fan_in)))
        return out

    shapes = {
        "wq": ((E, H * (NP + RP)), E),  # direct query projection (no q-LoRA)
        "w_dkv": ((E, R), E),  # -> c_kv
        "w_kr": ((E, RP), E),  # -> the shared rope key
        "w_uk": ((H, NP, R), NP),  # absorb: nope -> latent
        "w_uv": ((H, R, V), R),  # latent -> value
        "wo": ((H * V, E), H * V),
        "w_gate": ((E, F_), E),
        "w_up": ((E, F_), E),
        "w_down": ((F_, E), F_),
    }
    layers = {
        "attn_norm": torch.ones((L, E), dtype=dt, device=dev),
        "kv_norm": torch.ones((L, R), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, E), dtype=dt, device=dev),
    }
    for name, (shape, fan_in) in shapes.items():
        layers[name] = init(shape, fan_in, L)
    return MLAModel(
        cfg,
        embed=init((cfg.vocab_size, E), E),
        layers=layers,
        final_norm=torch.ones((E,), dtype=dt, device=dev),
        lm_head=init((E, cfg.vocab_size), E),
    )


def _zeros_pad(cfg: MLAConfig, like: torch.Tensor, lead) -> list:
    pad = cfg.cache_head_dim - cfg.latent_dim
    return [like.new_zeros(*lead, pad)] if pad else []


def _q_effective(cfg: MLAConfig, lp: dict, h: torch.Tensor, cos, sin) -> torch.Tensor:
    """Hidden states [T, E] → absorbed queries [T, H, cache_head_dim]
    (``cos``/``sin`` the rope tables of the T positions)."""
    T = h.shape[0]
    NP = cfg.qk_nope_head_dim
    H = lp["w_uk"].shape[0]
    q = (h @ lp["wq"]).reshape(T, H, -1)
    q_nope, q_rope = q[..., :NP], apply_rope(q[..., NP:], cos, sin)
    # absorb W_UK in float32: q_lat[t, h, r] = sum_n q_nope[t, h, n] w_uk[h, n, r]
    q_lat = torch.einsum("thn,hnr->thr", q_nope.float(), lp["w_uk"].float()).to(h.dtype)
    return torch.cat([q_lat, q_rope] + _zeros_pad(cfg, h, (T, H)), dim=-1)


def _latent_entry(cfg: MLAConfig, lp: dict, h: torch.Tensor, cos, sin) -> torch.Tensor:
    """Per-token cache entry [T, 1, cache_head_dim] = norm(c_kv) ++ rope(k_r)."""
    T = h.shape[0]
    c = rms_norm(h @ lp["w_dkv"], lp["kv_norm"], cfg.rms_eps)  # [T, R]
    k_r = apply_rope((h @ lp["w_kr"]).reshape(T, 1, -1), cos, sin)[:, 0]
    return torch.cat([c, k_r] + _zeros_pad(cfg, h, (T,)), dim=-1)[:, None, :]


def _out_proj(cfg: MLAConfig, lp: dict, attn_lat: torch.Tensor) -> torch.Tensor:
    """attn_lat [T, H, kv_lora_rank] → [T, H * v_head_dim] through W_UV, in
    float32."""
    o = torch.einsum("thr,hrv->thv", attn_lat.float(), lp["w_uv"].float())
    return o.reshape(attn_lat.shape[0], -1).to(attn_lat.dtype)


def _attention_block(cfg, lp, x, cos, sin, attend):
    """x [T, E] → x + the layer's attention output; ``attend(q_eff, ent)``
    writes the entries and returns the attention [T, H, cache_head_dim]."""
    R = cfg.kv_lora_rank
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    attn = attend(_q_effective(cfg, lp, h, cos, sin), _latent_entry(cfg, lp, h, cos, sin))
    return x + _out_proj(cfg, lp, attn[..., :R].to(x.dtype)) @ lp["wo"]


def _rope_tables(cfg: MLAConfig, positions: torch.Tensor):
    """cos/sin of the flattened positions, [T, 1, rope/2] each."""
    return rope_cos_sin(positions.reshape(-1), cfg.qk_rope_head_dim, cfg.rope_theta)


def mla_decode_step(
    params: MLAModel,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B]
    k_pools: torch.Tensor,  # [L, num_pages, 1, page_tokens, cache_head_dim]
    v_pools,  # ignored (None)
    page_tables: torch.Tensor,
    slot_pages: torch.Tensor,
    slot_offsets: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    quant_scales: tuple | None = None,  # (k_scales, v_scales) [L, 1] float32
    reference_attention: bool = False,
    collect_kv: bool = False,
):
    """One decode token for each of B sequences.  Returns (logits [B, V]
    float32, k_pools, None); the pool is written in place.
    ``quant_scales``, ``reference_attention`` and ``collect_kv`` as in
    :func:`~kvcached_tpu_torch.models.llama.llama_decode_step`; the
    collected entries are the latent ones, ``(ks [L, B, 1, D], None)``."""
    decode = paged_attention_decode_plain if reference_attention else paged_attention_decode
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    cos, sin = _rope_tables(cfg, positions)
    x = params.embed[tokens]  # [B, E]
    kv = KVCollector(collect_kv)
    for i in range(cfg.num_layers):
        lp = params.layer(i)

        def attend(q_eff, ent, i=i):
            return decode(
                cast(q_eff), k_pools, None, page_tables, seq_lens, i,
                kv(cast(ent))[0], None, slot_pages, slot_offsets,
                sm_scale=cfg.sm_scale, mla_v_dim=cfg.kv_lora_rank, **scales)[0]

        x = _mlp(_attention_block(cfg, lp, x, cos, sin, attend), lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return kv.result(lm_head_logits(x, params.lm_head), k_pools, None)


def mla_verify_step(
    params: MLAModel,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # [B, T]: [last_token, draft_1 .. draft_{T-1}]
    positions: torch.Tensor,  # [B, T]
    k_pools: torch.Tensor,
    v_pools,  # ignored (None)
    page_tables: torch.Tensor,
    slot_pages: torch.Tensor,  # [B, T] (0 = discard)
    slot_offsets: torch.Tensor,  # [B, T]
    seq_lens: torch.Tensor,  # [B] INCLUDING all T fed tokens
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
    collect_kv: bool = False,
):
    """Speculative-decode verification: T tokens per sequence in one
    absorbed-attention pass over the latent pool.  Returns (logits
    [B, T, V] float32, k_pools, None).  ``quant_scales`` and
    ``collect_kv`` (``(ks [L, B, T, 1, D], None)``) as in
    :func:`mla_decode_step`."""
    verify = paged_attention_verify_plain if reference_attention else paged_attention_verify
    B, T = tokens.shape
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    cos, sin = _rope_tables(cfg, positions)
    x = params.embed[tokens].reshape(B * T, -1)
    kv = KVCollector(collect_kv)
    for i in range(cfg.num_layers):
        lp = params.layer(i)

        def attend(q_eff, ent, i=i):
            out = verify(
                cast(q_eff).reshape(B, T, -1, cfg.cache_head_dim), k_pools, None,
                page_tables, seq_lens, i, kv(cast(ent).reshape(B, T, 1, -1))[0], None,
                slot_pages, slot_offsets, sm_scale=cfg.sm_scale,
                mla_v_dim=cfg.kv_lora_rank, **scales)[0]
            return out.reshape(B * T, -1, cfg.cache_head_dim)

        x = _mlp(_attention_block(cfg, lp, x, cos, sin, attend), lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return kv.result(lm_head_logits(x, params.lm_head).reshape(B, T, -1), k_pools, None)


def mla_prefill_batch_step(
    params: MLAModel,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # [N, T]: N chunks padded to a shared bucket
    positions: torch.Tensor,  # [N, T]
    k_pools: torch.Tensor,
    v_pools,  # ignored (None)
    chunk_pages: torch.Tensor,  # [N, T // page_tokens] (0 = discard)
    page_tables: torch.Tensor,  # [N, max_pages]
    q_starts: torch.Tensor,  # [N]
    true_lens: torch.Tensor,  # [N] (0 = pad row)
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Batched prefill: N chunks in one pass over the latent pool, each row
    writing its chunk through its own pages and attending with its own
    (q_start, true_len), identical to N serial :func:`mla_prefill_step`
    calls.  Returns (logits at each row's last real token [N, V] float32,
    k_pools, None).  ``quant_scales`` as in :func:`mla_decode_step` (the
    page writer takes each layer's K scale)."""
    if reference_attention:
        write, attend_fn = write_prefill_kv_single_plain, paged_prefill_attention_batch_plain
    else:
        write, attend_fn = write_prefill_kv_single, paged_prefill_attention_batch
    N, T = tokens.shape
    cast, scales = _kernel_inputs(k_pools.dtype, quant_scales)
    q_starts = q_starts.to(torch.int32)
    true_lens = true_lens.to(torch.int32)
    kv_lens = q_starts + true_lens
    flat_pages = chunk_pages.reshape(-1).to(torch.int32).contiguous()
    cos, sin = _rope_tables(cfg, positions)
    x = params.embed[tokens].reshape(N * T, -1)
    for i in range(cfg.num_layers):
        lp = params.layer(i)

        def attend(q_eff, ent, i=i):
            # page writes don't care which row a page belongs to: one
            # [1, N*T, D] stream over N*T/P pages
            write(k_pools, cast(ent).transpose(0, 1), flat_pages, i,
                  **({"scale": quant_scales[0][i]} if scales else {}))
            out = attend_fn(
                cast(q_eff).reshape(N, T, -1, cfg.cache_head_dim), k_pools, None,
                page_tables, q_starts, kv_lens, i, sm_scale=cfg.sm_scale,
                mla_v_dim=cfg.kv_lora_rank, **scales)
            return out.reshape(N * T, -1, cfg.cache_head_dim)

        x = _mlp(_attention_block(cfg, lp, x, cos, sin, attend), lp, cfg.rms_eps)
    x = rms_norm(x, params.final_norm, cfg.rms_eps).reshape(N, T, -1)
    last = x[torch.arange(N, device=x.device), (true_lens.long() - 1).clamp(min=0)]
    return lm_head_logits(last, params.lm_head), k_pools, None


def mla_prefill_step(
    params: MLAModel,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # [T]
    positions: torch.Tensor,  # [T]
    k_pools: torch.Tensor,
    v_pools,  # ignored (None)
    chunk_pages: torch.Tensor,  # [T // page_tokens]
    page_table: torch.Tensor,  # [max_pages]
    q_start,
    true_len,
    *,
    quant_scales: tuple | None = None,
    reference_attention: bool = False,
):
    """Prefill one chunk of one sequence: the N=1 view of
    :func:`mla_prefill_batch_step`.  Returns (logits_last [V] float32,
    k_pools, None)."""
    dev = tokens.device
    as_row = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(1)  # noqa: E731
    logits, k_pools, _ = mla_prefill_batch_step(
        params, cfg, tokens[None], positions[None], k_pools, None, chunk_pages[None],
        page_table[None], as_row(q_start), as_row(true_len),
        quant_scales=quant_scales, reference_attention=reference_attention)
    return logits[0], k_pools, None

