"""Paged decode attention (K1, K1r), the prefill page writer (K2) and the
speculative-decode verify (K4).

Port of the Pallas kernels of ``kvcached_tpu/ops/paged_attention.py``:

- :func:`paged_attention_decode` (K1) replaces ``paged_attention_decode``
  (``_decode_write_kernel`` over ``_attn_body``): write each row's current
  token K/V into its slot, then flash-decode over the row's pages.
- :func:`paged_attention` (K1r) replaces the read-only ``paged_attention``
  (``_readonly_kernel``); it is the same CUDA kernel with the write off.
- :func:`write_prefill_kv` (K2) replaces ``write_prefill_kv``
  (``_prefill_write_kernel``): copy a page-aligned chunk into its pages.
- :func:`paged_attention_verify` (K4) replaces ``paged_attention_verify``
  (``_verify_write_kernel`` over ``_verify_body``): write each row's T fed
  tokens into their slots, then causal multi-query attention over the pages
  (speculative-decode verification).
- The MLA mode (``mla_v_dim``) of :func:`paged_attention_decode` and
  :func:`paged_attention_verify` (K5) replaces ``_decode_write_kernel_mla``
  and ``_verify_write_kernel_mla``: one latent pool serves as K (all of its
  lanes) and V (its first ``mla_v_dim`` lanes).  Both launch
  ``csrc/mla_attend.cu`` through :func:`paged_attention_decode_mla` and
  :func:`paged_attention_verify_mla`.
- :func:`write_prefill_kv_single` (K6) replaces ``write_prefill_kv_single``
  (``_prefill_write_single_kernel``): K2 for the single latent pool.
- :func:`write_decode_tokens` (K7) and :func:`write_decode_tokens_single`
  (K8) replace ``write_decode_tokens`` and ``write_decode_tokens_single``
  (``_decode_tokens_write_kernel``, ``_decode_tokens_write_single_kernel``):
  one decode token per (kv layer, row), the dp-replica equalizer's store.

Each wrapper launches its hand-written CUDA kernel (``csrc/paged_decode.cu``,
``csrc/prefill_write.cu``, ``csrc/paged_verify.cu``, ``csrc/mla_attend.cu``,
``csrc/decode_tokens_write.cu``) on
``torch.cuda.current_stream()`` when given CUDA
tensors, and runs the plain PyTorch version beside it (``*_plain``) only
when given CPU tensors.  There is no fallback: a CUDA call that the kernel
does not take raises.  The pools are updated in place and returned, where
the JAX package donated them and got new arrays back.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``.

The kernels take float32, bfloat16, int8 and float8_e4m3fn pools with
head_dim 128 or 256 (:data:`KERNEL_HEAD_DIM`: K1, K1r, K3 and K4 launch
an instance compiled for the pools' width, K2 copies any width), and in
the MLA mode one latent pool of any of these types at
DeepSeek-V2's width (640 lanes, values 512).  Byte pools hold what the
reference's writes store: int8 ``clip(round(x / scale), -127, 127)`` with
per-(layer, kv head) float32 scales ``[L, KH]`` (the K scale folds into the
scores, the V scale into the output; a latent pool has one scale a layer,
``[L, 1]``, its K scale, which serves the values too), e4m3 the float32
value rounded to nearest even with NaN past ±464 (:func:`to_e4m3`); their
matmuls take bf16 operands with float32 accumulation, as the TPU kernels'
do.  Logit soft-capping (Gemma2's ``attn_logit_softcapping``: ``cap *
tanh(score / cap)`` before the mask) is ported in K1, K1r, K3 and K4
(``logit_softcap``, on every pool type; the cap picks a capping instance
of the kernel at launch); in the MLA modes it raises
``NotImplementedError``, as do the MLA mode of the read-only
:func:`paged_attention` and the MLA mode with several kv heads or a window:
they are not ported yet.  Each wrapper counts its launches in
``<wrapper>.launches`` and by pool type in ``<wrapper>.launches_by_dtype``,
soft-capped launches under the pool type's name plus ``+softcap``, and
launches at head_dim 256 with ``+d256`` after that.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: pool type → the kernels' dtype code (csrc/kv_common.cuh DType)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                 torch.float8_e4m3fn: 3}
#: pools of one byte a value: quantized on write, bf16 matmul operands
BYTE_DTYPES = (torch.int8, torch.float8_e4m3fn)
#: the largest magnitude the reference's float32 → e4m3 conversion keeps
#: finite: 464 ties to 448, anything larger becomes NaN
E4M3_LIMIT = 464.0
#: head dims the K1-K4 kernels take (a library compiled for each, csrc
#: KVC_HEAD_DIM); any other width raises ValueError
KERNEL_HEAD_DIM = _build.HEAD_DIMS
MAX_GQA_GROUP = 16
#: tokens per block of K1's split-K pass (csrc/paged_decode.cu SPLIT)
DECODE_SPLIT = 256
#: tokens per block of K4's split-K pass (csrc/paged_verify.cu SPLIT)
VERIFY_SPLIT = 256
#: query rows (fed tokens x GQA group) one K4 block holds (csrc/paged_verify.cu ROWS)
MAX_VERIFY_ROWS = 64
#: the MLA kernels' latent and value widths (csrc/mla_attend.cu D, R):
#: DeepSeek-V2's kv_lora_rank 512 + rope 64 lanes, padded to 640
MLA_HEAD_DIM = 640
MLA_V_DIM = 512
#: query rows one MLA block holds, by latent pool type (csrc/mla_attend.cu
#: MAX_ROWS for the tensor-core kernel, F32_ROWS for the float32 one; byte
#: pools multiply bf16 operands on the tensor cores even for float32 models)
MLA_ROWS = {torch.bfloat16: 64, torch.int8: 64, torch.float8_e4m3fn: 64,
            torch.float32: 16}
#: keys per MLA tile (csrc/mla_attend.cu KT) and the fewest keys per block
#: of the MLA split-K pass
MLA_KEY_TILE = 32
MLA_MIN_SPLIT = 128


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------


def _unsupported(mla_v_dim=None, logit_softcap=None, pool_dtype=None) -> None:
    if mla_v_dim is not None:
        raise NotImplementedError("the MLA single-buffer mode is not ported yet")
    if logit_softcap is not None:
        raise NotImplementedError("logit soft-capping in the MLA modes is not ported yet")
    if pool_dtype is not None and pool_dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{pool_dtype} pools are not ported yet "
            "(float32, bfloat16, int8, float8_e4m3fn)")


def _count(wrapper, dtype, softcap=0.0, head_dim=KERNEL_HEAD_DIM[0]) -> None:
    """One launch of ``wrapper``'s kernel on a ``dtype`` pool, counted by
    pool type under ``"<type>+softcap"`` when it soft-capped, with
    ``"+d<head_dim>"`` after that at a head_dim other than 128."""
    wrapper.launches += 1
    name = (str(dtype).replace("torch.", "") + ("+softcap" if softcap else "")
            + ("" if head_dim == KERNEL_HEAD_DIM[0] else f"+d{head_dim}"))
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name, 0) + 1


def _softcap_arg(logit_softcap) -> float:
    """The kernels' soft-cap argument: the cap as a positive float, 0 for
    none."""
    if logit_softcap is None:
        return 0.0
    cap = float(logit_softcap)
    if not cap > 0:
        raise ValueError(f"logit_softcap must be positive, got {logit_softcap}")
    return cap


def _soft_cap(s, logit_softcap):
    """float32 scores ``s`` after logit soft-capping, as the reference
    computes it: ``s * (1 / cap)``, tanh, times ``cap`` (None: unchanged)."""
    if logit_softcap is None:
        return s
    return logit_softcap * torch.tanh(s * (1.0 / logit_softcap))


def _head_scales(scales, pool_dtype, layer):
    """Layer ``layer``'s per-kv-head int8 scales [KH] float32, or None where
    none apply (other pools, or no scales: the reference's ones)."""
    if scales is None or pool_dtype != torch.int8:
        return None
    return scales[int(layer)].float()


def _scales_arg(scales, pool_dtype, L, KH, device):
    """The int8 scales [L, KH] as the kernels take them (float32,
    contiguous, on the pools' device), or None."""
    if scales is None or pool_dtype != torch.int8:
        return None
    scales = scales.to(device=device, dtype=torch.float32).contiguous()
    if tuple(scales.shape) != (L, KH):
        raise ValueError(f"int8 scales must be [L, KH] = {(L, KH)}, got {tuple(scales.shape)}")
    return scales


def _ptr(t):
    return None if t is None else t.data_ptr()


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8_e4m3fn the way the reference converts it (float32 →
    e4m3, round to nearest even, no saturation): NaN with ``x``'s sign where
    ``|x| > 464`` or ``x`` is not finite.  torch's own cast saturates at
    ±448 instead; the two agree everywhere else."""
    x = x.float()
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    bits = torch.where(x.abs() <= E4M3_LIMIT, bits, nan)
    return bits.view(torch.float8_e4m3fn)


def quantize_kv(x: torch.Tensor, dtype, scale=None) -> torch.Tensor:
    """``x`` as a ``dtype`` pool stores it, the reference's write: int8
    ``clip(round(x / scale), -127, 127)`` in float32 (round half to even;
    NaN becomes 0, as XLA converts it; ``scale`` broadcasts against ``x``,
    None is 1), e4m3 :func:`to_e4m3`, any other type a cast."""
    if dtype == torch.int8:
        x = x.float()
        if scale is not None:
            x = x / scale
        x = torch.clamp(torch.round(x), -127, 127)
        return torch.nan_to_num(x, nan=0.0).to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        return to_e4m3(x)
    return x.to(dtype)


def _mm_dtype(pool_dtype):
    """Matmul operand type of a pool: float32 pools multiply in float32,
    narrower ones in bf16 (int8 and e4m3 values are exact in bf16)."""
    return torch.float32 if pool_dtype == torch.float32 else torch.bfloat16


def _io_dtypes(pool_dtype):
    """(q, written-token, output) types of the CUDA kernels for a pool: the
    pool's own type for float32 and bf16 pools; for byte pools bf16 q (the
    matmul operand), float32 tokens (quantized in the kernel) and a float32
    output."""
    if pool_dtype in BYTE_DTYPES:
        return torch.bfloat16, torch.float32, torch.float32
    return pool_dtype, pool_dtype, pool_dtype


def _out(o, pool_dtype, q_dtype):
    """The kernels' output: rounded to the pool's type for float32 and
    bf16 pools (their q and output are in it), straight to q's type for
    byte pools (the reference's output dtype)."""
    if pool_dtype in BYTE_DTYPES:
        return o.to(q_dtype)
    return o.to(pool_dtype).to(q_dtype)


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (plain path), False when every
    one lies on one CUDA device (kernel path); raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return False


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _require_pools(k_pool, v_pool) -> tuple[int, int, int, int, int]:
    if k_pool.dim() != 5:
        raise ValueError(f"pools must be [L, pages, KH, page_tokens, D], got {tuple(k_pool.shape)}")
    _require(v_pool, "v_pool", k_pool.dtype, k_pool.shape)
    if not k_pool.is_contiguous():
        raise ValueError("k_pool: must be contiguous")
    L, P, KH, TP, D = k_pool.shape
    if D not in KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head_dim {KERNEL_HEAD_DIM}, got {D}")
    return L, P, KH, TP, D


def _require_aligned(what: str, *tensors) -> None:
    """The kernels move K/V/q rows as 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} needs 16-byte aligned tensors")


def _layer_index(layer, num_layers: int) -> int:
    layer = int(layer)
    if not 0 <= layer < num_layers:
        raise IndexError(f"layer {layer} out of range for {num_layers} pool layers")
    return layer


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _op_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 value of x after rounding to the matmul operand type."""
    return x.to(dtype).float()


def _masked_softmax_pv(s, valid, v, op_dtype, v_scale=None):
    """Softmax over the last axis of float32 scores ``s`` restricted to
    ``valid``, times float32 values ``v``: the function every flash loop of
    the kernels computes.  The weights are rounded to the operand type
    before they multiply V (bf16 operands), the int8 V scale ``v_scale``
    (broadcasting against the product) multiplies their product, and a row
    with nothing valid yields zeros."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(_op_round(p, op_dtype), v)
    if v_scale is not None:
        pv = pv * v_scale
    return pv / torch.where(l == 0, torch.ones_like(l), l)


def _gather_pages(pool_layer, page_tables):
    """[P, KH, TP, D] pool layer + [B, maxp] table → float32 [B, KH, maxp*TP, D]."""
    B, maxp = page_tables.shape
    _, KH, TP, D = pool_layer.shape
    x = pool_layer[page_tables.long()]  # [B, maxp, KH, TP, D]
    return x.permute(0, 2, 1, 3, 4).reshape(B, KH, maxp * TP, D).float()


# ---------------------------------------------------------------------------
# K1 / K1r: paged decode attention
# ---------------------------------------------------------------------------


def _write_slots(pool, layer, new, slot_pages, slot_offsets, scale=None):
    """Store each token of ``new`` [..., KH, D] at its (page, offset) slot
    of ``layer`` (quantized for a byte pool, ``scale`` [KH] the int8
    scales); slots on the zero page are discarded."""
    keep = slot_pages != 0
    pages, offs = slot_pages[keep].long(), slot_offsets[keep].long()
    pool[layer, pages, :, offs] = quantize_kv(
        new[keep], pool.dtype, None if scale is None else scale[:, None])


def _kv_values(k_pool, v_pool, layer, page_tables, mla_v_dim):
    """Gathered float32 keys and values of ``layer``: in the MLA mode the
    values are the first ``mla_v_dim`` lanes of the one latent pool."""
    k = _gather_pages(k_pool[layer], page_tables)
    if mla_v_dim is not None:
        return k, k[..., :mla_v_dim]
    return k, _gather_pages(v_pool[layer], page_tables)


def _pad_lanes(o, D):
    """MLA mode: output lanes past the values are zero, as in the TPU
    kernels' accumulator."""
    return torch.nn.functional.pad(o, (0, D - o.shape[-1])) if o.shape[-1] < D else o


def paged_attention_decode_plain(
    q, k_pool, v_pool, page_tables, seq_lens, layer,
    k_new, v_new, slot_pages, slot_offsets,
    *, sm_scale=None, window=None, write_kv=True, mla_v_dim=None,
    k_scales=None, v_scales=None, logit_softcap=None,
):
    """Plain PyTorch version of K1 (``write_kv=True``), K1r and, with
    ``mla_v_dim``, K5's decode form (``v_pool`` and ``v_new`` unused): the
    same function as the CUDA kernels, in dense tensor ops.  Byte pools
    quantize the written token; int8 ``k_scales``/``v_scales`` [L, KH] (in
    the MLA mode the K scales serve the values too); ``logit_softcap`` caps
    the scores before the mask."""
    B, QH, D = q.shape
    KH = k_pool.shape[2]
    G = QH // KH
    dt = k_pool.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    layer = int(layer)
    ksc = _head_scales(k_scales, dt, layer)
    # the MLA mode's values are lanes of the K entries: the K scales serve them
    vsc = ksc if mla_v_dim is not None else _head_scales(v_scales, dt, layer)
    if write_kv:
        _write_slots(k_pool, layer, k_new, slot_pages, slot_offsets, ksc)
        if mla_v_dim is None:
            _write_slots(v_pool, layer, v_new, slot_pages, slot_offsets, vsc)
    k, v = _kv_values(k_pool, v_pool, layer, page_tables, mla_v_dim)
    mm = _mm_dtype(dt)
    qg = _op_round(q.reshape(B, KH, G, D), mm)
    s = torch.matmul(qg, k.transpose(-1, -2)) * sm_scale  # [B, KH, G, S]
    if ksc is not None:
        s = s * ksc[:, None, None]
    s = _soft_cap(s, logit_softcap)
    pos = torch.arange(k.shape[2], device=q.device)[None]
    sl = seq_lens.long()[:, None]
    valid = pos < sl
    if window:
        valid = valid & (pos >= (sl - window).clamp(min=0))
    o = _masked_softmax_pv(s, valid[:, None, None, :], v, mm,
                           None if vsc is None else vsc[:, None, None])
    return _out(_pad_lanes(o, D).reshape(B, QH, D), dt, q.dtype), k_pool, v_pool


def _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer, k_new,
                   v_new, slot_pages, slot_offsets, sm_scale, window, write_kv,
                   k_scales=None, v_scales=None, softcap=0.0):
    L, P, KH, TP, D = _require_pools(k_pool, v_pool)
    B, QH, Dq = q.shape
    if Dq != D or QH % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    G = QH // KH
    if G > MAX_GQA_GROUP:
        raise ValueError(f"GQA group {G} > {MAX_GQA_GROUP} is not supported")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    qdt, ndt, odt = _io_dtypes(dt)
    qc = q.to(qdt).contiguous()
    ks = _scales_arg(k_scales, dt, L, KH, q.device)
    vs = _scales_arg(v_scales, dt, L, KH, q.device)
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (B, maxp))
    _require(seq_lens, "seq_lens", torch.int32, (B,))
    if write_kv:
        k_new = k_new.to(ndt).contiguous()
        v_new = v_new.to(ndt).contiguous()
        _require(k_new, "k_new", ndt, (B, KH, D))
        _require(v_new, "v_new", ndt, (B, KH, D))
        _require(slot_pages, "slot_pages", torch.int32, (B,))
        _require(slot_offsets, "slot_offsets", torch.int32, (B,))
        _require_aligned("K1", k_new, v_new)
        ptrs = (k_new.data_ptr(), v_new.data_ptr(),
                slot_pages.data_ptr(), slot_offsets.data_ptr())
    else:
        ptrs = (None, None, None, None)
    _require_aligned("K1", qc, k_pool, v_pool)
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty(qc.shape, dtype=odt, device=q.device)
    # per-split partials (max, sum, acc) of the split-K pass
    GT = 4 if G <= 4 else (8 if G <= 8 else 16)
    splits = -(-maxp * TP // DECODE_SPLIT)
    scratch = torch.empty(B * KH * splits * GT * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load(_build.lib_name("paged_decode", D))
    rc = lib.kvc_paged_decode(
        KERNEL_DTYPES[dt], D, qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), *ptrs, _ptr(ks), _ptr(vs),
        out.data_ptr(), scratch.data_ptr(), B, layer, P, KH, G, TP, maxp,
        int(window or 0), float(sm_scale), float(softcap), int(write_kv), _stream(q),
    )
    _build.check(rc, "paged_decode")
    return out.to(q.dtype), D


def paged_attention_decode(
    q: torch.Tensor,  # [B, num_q_heads, head_dim]
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int32 physical ids
    seq_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
    layer,
    k_new: torch.Tensor,  # [B, num_kv_heads, head_dim] current token's K
    v_new: torch.Tensor,
    slot_pages: torch.Tensor,  # [B] int32 (0 = discard)
    slot_offsets: torch.Tensor,  # [B] int32
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    mla_v_dim: int | None = None,
    k_scales=None,
    v_scales=None,
    logit_softcap: float | None = None,
):
    """K1: fused decode step.  Writes the current token's K/V into its page,
    then attends over the row's tokens.  Returns ``(out [B, QH, D], k_pool,
    v_pool)``; the pools are updated in place.

    Replaces the Pallas ``_decode_write_kernel``.  Bound on the card by
    device-memory bytes (each row's K/V is read once, ~G FLOPs a byte);
    ``csrc/paged_decode.cu`` splits each (row, kv head) into 256-token
    blocks so that a small batch still fills the SMs, then merges them.

    Byte pools (int8 with ``k_scales``/``v_scales`` [L, KH], or e4m3):
    ``k_new``/``v_new`` come unquantized and the kernel quantizes them on
    write; the output is in q's type.

    ``logit_softcap``: Gemma2's attention soft-cap, ``cap * tanh(score /
    cap)`` on the scaled scores before the mask, on every pool type (one
    ``tanhf`` a score on the CUDA cores).

    ``mla_v_dim``: K5's decode form (``_decode_write_kernel_mla``).
    ``k_pool`` is the single latent pool, ``k_new`` the latent entries;
    scores use all lanes, values the first ``mla_v_dim``; ``v_pool`` and
    ``v_new`` are ignored and ``None`` is returned in ``v_pool``'s place.
    An int8 latent pool takes ``k_scales`` [L, 1] for keys and values
    (``v_scales`` is checked and unused)."""
    if mla_v_dim is not None:
        ks = _mla_mode(k_pool, window, k_scales, v_scales, logit_softcap)
        if _on_cpu(q, k_pool, page_tables, seq_lens, k_new, slot_pages, slot_offsets):
            out = paged_attention_decode_plain(
                q, k_pool, None, page_tables, seq_lens, layer, k_new, None,
                slot_pages, slot_offsets, sm_scale=sm_scale, mla_v_dim=mla_v_dim,
                k_scales=ks)[0]
        else:
            out = paged_attention_decode_mla(
                q, k_pool, page_tables, seq_lens, layer, k_new, slot_pages,
                slot_offsets, sm_scale=sm_scale, mla_v_dim=mla_v_dim, k_scales=ks)
        return out, k_pool, None
    _unsupported(pool_dtype=k_pool.dtype)
    cap = _softcap_arg(logit_softcap)
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens, k_new, v_new,
               slot_pages, slot_offsets):
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, k_new, v_new,
            slot_pages, slot_offsets, sm_scale=sm_scale, window=window,
            k_scales=k_scales, v_scales=v_scales, logit_softcap=logit_softcap)
    out, D = _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer,
                            k_new, v_new, slot_pages, slot_offsets, sm_scale,
                            window, True, k_scales, v_scales, cap)
    _count(paged_attention_decode, k_pool.dtype, cap, D)
    return out, k_pool, v_pool


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,  # [(L,) num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    layer=0,
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    mla_v_dim: int | None = None,
    k_scales=None,
    v_scales=None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """K1r: read-only paged attention (no KV write).  Returns [B, QH, D].

    Replaces the Pallas ``_readonly_kernel``: K1's CUDA kernel with the
    write off, bound and design as K1, ``logit_softcap`` as in
    :func:`paged_attention_decode`."""
    _unsupported(mla_v_dim, pool_dtype=k_pool.dtype)
    cap = _softcap_arg(logit_softcap)
    if k_pool.dim() == 4:
        k_pool, v_pool = k_pool[None], v_pool[None]
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens):
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, None, None,
            None, None, sm_scale=sm_scale, window=window, write_kv=False,
            k_scales=k_scales, v_scales=v_scales, logit_softcap=logit_softcap)[0]
    out, D = _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer,
                            None, None, None, None, sm_scale, window, False,
                            k_scales, v_scales, cap)
    _count(paged_attention, k_pool.dtype, cap, D)
    return out


# ---------------------------------------------------------------------------
# K2: prefill page writer
# ---------------------------------------------------------------------------


def write_prefill_kv_plain(k_pool, v_pool, k_new, v_new, pages, layer, *,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version of K2 (byte pools quantize: ``k_scale`` /
    ``v_scale`` are the layer's int8 scales [KH])."""
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    n = T // TP
    layer = int(layer)
    keep = pages != 0  # zero page: discard
    idx = pages[keep].long()
    for pool, new, sc in ((k_pool, k_new, k_scale), (v_pool, v_new, v_scale)):
        sc = None if sc is None or pool.dtype != torch.int8 else sc.float()[:, None, None]
        chunks = quantize_kv(new, pool.dtype, sc).reshape(KH, n, TP, D).transpose(0, 1)
        pool[layer, idx] = chunks[keep]
    return k_pool, v_pool


def write_prefill_kv(
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [num_kv_heads, T, head_dim]; T multiple of page_tokens
    v_new: torch.Tensor,
    pages: torch.Tensor,  # [T // page_tokens] int32 physical pages (0 = discard)
    layer,
    *,
    k_scale=None,
    v_scale=None,
):
    """K2: write a prefill chunk's KV into its pages, in place.  Returns
    ``(k_pool, v_pool)``.

    Replaces the Pallas ``_prefill_write_kernel``.  A pure copy, bound by
    device-memory bytes; ``csrc/prefill_write.cu`` gives each (page, kv
    head) slab one block that moves it as 16-byte vectors.  Byte pools:
    ``k_new``/``v_new`` come unquantized and the kernel quantizes them in
    the same pass (int8 with the layer's scales ``k_scale``/``v_scale``
    [KH], which the reference requires; e4m3 by :func:`to_e4m3`'s rule)."""
    _unsupported(pool_dtype=k_pool.dtype)
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    if T % TP:
        raise ValueError(f"prefill length {T} must be a multiple of page_tokens {TP}")
    if k_pool.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("int8 pools need per-head scales k_scale and v_scale")
    if _on_cpu(k_pool, v_pool, k_new, v_new, pages):
        return write_prefill_kv_plain(k_pool, v_pool, k_new, v_new, pages, layer,
                                      k_scale=k_scale, v_scale=v_scale)
    L, P, KHp, _, Dp = _require_pools(k_pool, v_pool)
    if (KHp, Dp) != (KH, D):
        raise ValueError(f"k_new {tuple(k_new.shape)} does not fit pools {tuple(k_pool.shape)}")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    n = T // TP
    _require(pages, "pages", torch.int32, (n,))
    lib = _build.load("prefill_write")
    if dt in BYTE_DTYPES:
        k_new = k_new.float().contiguous()
        v_new = v_new.float().contiguous()
        _require(v_new, "v_new", torch.float32, k_new.shape)
        scales = [_scales_arg(sc if sc is None else sc.reshape(1, KH), dt, 1, KH,
                              k_pool.device) for sc in (k_scale, v_scale)]
        _require_aligned("K2", k_new, v_new, k_pool, v_pool)
        rc = lib.kvc_prefill_write_quant(
            KERNEL_DTYPES[dt], k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
            *map(_ptr, scales), layer, P, KH, n, TP * D, _stream(k_pool))
    else:
        k_new = k_new.to(dt).contiguous()
        v_new = v_new.to(dt).contiguous()
        _require(v_new, "v_new", dt, k_new.shape)
        _require_aligned("K2", k_new, v_new, k_pool, v_pool)
        rc = lib.kvc_prefill_write(
            k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), pages.data_ptr(), layer, P, KH, n,
            TP * D * k_pool.element_size(), _stream(k_pool))
    _build.check(rc, "prefill_write")
    _count(write_prefill_kv, dt, head_dim=D)
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# K4: speculative-decode verify (write T fed tokens, causal multi-query attend)
# ---------------------------------------------------------------------------


def paged_attention_verify_plain(
    q, k_pool, v_pool, page_tables, seq_lens, layer,
    k_new, v_new, slot_pages, slot_offsets, *, sm_scale=None, window=None,
    mla_v_dim=None, k_scales=None, v_scales=None, logit_softcap=None,
):
    """Plain PyTorch version of K4 and, with ``mla_v_dim``, of K5's verify
    form (``v_pool`` and ``v_new`` unused): the same function as the CUDA
    kernels, in dense tensor ops.  Keys past the page-table width do not
    exist (the table is gathered whole), as the kernels clamp their range.
    Byte pools and ``logit_softcap`` as in
    :func:`paged_attention_decode_plain`."""
    B, T, QH, D = q.shape
    KH = k_pool.shape[2]
    G = QH // KH
    dt = k_pool.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    layer = int(layer)
    ksc = _head_scales(k_scales, dt, layer)
    # the MLA mode's values are lanes of the K entries: the K scales serve them
    vsc = ksc if mla_v_dim is not None else _head_scales(v_scales, dt, layer)
    _write_slots(k_pool, layer, k_new, slot_pages, slot_offsets, ksc)
    if mla_v_dim is None:
        _write_slots(v_pool, layer, v_new, slot_pages, slot_offsets, vsc)
    k, v = _kv_values(k_pool, v_pool, layer, page_tables, mla_v_dim)
    # [B, T, KH, G, D] -> [B, KH, T*G, D], row = t * G + g
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 1, 3, 4).reshape(B, KH, T * G, D)
    mm = _mm_dtype(dt)
    s = torch.matmul(_op_round(qg, mm), k.transpose(-1, -2)) * sm_scale
    if ksc is not None:
        s = s * ksc[:, None, None]
    s = _soft_cap(s, logit_softcap)
    pos = torch.arange(k.shape[2], device=q.device)[None, None]
    # query row r = t*G + g sits at seq_len - T + t and sees keys below
    # seq_len - T + t + 1
    limit = seq_lens.long()[:, None] - T + torch.arange(T, device=q.device)[None] + 1
    limit = limit.repeat_interleave(G, dim=1)[:, :, None]  # [B, R, 1]
    valid = (pos < limit) & (pos < seq_lens.long()[:, None, None])
    if window:
        valid = valid & (pos >= (limit - window).clamp(min=0))
    o = _masked_softmax_pv(s, valid[:, None], v, mm,
                           None if vsc is None else vsc[:, None, None])
    o = _pad_lanes(o, D)  # [B, KH, R, D]
    o = o.reshape(B, KH, T, G, D).permute(0, 2, 1, 3, 4).reshape(B, T, QH, D)
    return _out(o, dt, q.dtype), k_pool, v_pool


def paged_attention_verify(
    q: torch.Tensor,  # [B, T, num_q_heads, head_dim]
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int32 physical ids
    seq_lens: torch.Tensor,  # [B] int32 INCLUDING the T fed tokens
    layer,
    k_new: torch.Tensor,  # [B, T, num_kv_heads, head_dim] the fed tokens' K
    v_new: torch.Tensor,
    slot_pages: torch.Tensor,  # [B, T] int32 (0 = discard)
    slot_offsets: torch.Tensor,  # [B, T] int32
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    mla_v_dim: int | None = None,
    k_scales=None,
    v_scales=None,
    logit_softcap: float | None = None,
):
    """K4: speculative-decode verification.  Writes each row's T fed
    tokens' K/V into their slots, then query t of row b, at position
    ``seq_lens[b] - T + t``, attends the row's keys up to and including its
    own position (and within ``window``).  Returns ``(out [B, T, QH, D],
    k_pool, v_pool)``; the pools are updated in place.

    Replaces the Pallas ``_verify_write_kernel``.  Bound on the card by
    device-memory bytes, as K1: each row's K/V is read once for all T
    queries.  ``csrc/paged_verify.cu`` writes the tokens in one launch,
    then splits each (row, kv head) into 256-token blocks that hold all
    T*G query rows of the head (bf16 on the tensor cores), and merges the
    blocks' partials.

    Byte pools and ``logit_softcap`` as in :func:`paged_attention_decode`.

    ``mla_v_dim``: K5's verify form (``_verify_write_kernel_mla``), as in
    :func:`paged_attention_decode`."""
    if mla_v_dim is not None:
        ks = _mla_mode(k_pool, window, k_scales, v_scales, logit_softcap)
        if _on_cpu(q, k_pool, page_tables, seq_lens, k_new, slot_pages, slot_offsets):
            out = paged_attention_verify_plain(
                q, k_pool, None, page_tables, seq_lens, layer, k_new, None,
                slot_pages, slot_offsets, sm_scale=sm_scale, mla_v_dim=mla_v_dim,
                k_scales=ks)[0]
        else:
            out = paged_attention_verify_mla(
                q, k_pool, page_tables, seq_lens, layer, k_new, slot_pages,
                slot_offsets, sm_scale=sm_scale, mla_v_dim=mla_v_dim, k_scales=ks)
        return out, k_pool, None
    _unsupported(pool_dtype=k_pool.dtype)
    cap = _softcap_arg(logit_softcap)
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens, k_new, v_new,
               slot_pages, slot_offsets):
        return paged_attention_verify_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, k_new, v_new,
            slot_pages, slot_offsets, sm_scale=sm_scale, window=window,
            k_scales=k_scales, v_scales=v_scales, logit_softcap=logit_softcap)
    L, P, KH, TP, D = _require_pools(k_pool, v_pool)
    B, T, QH, Dq = q.shape
    if Dq != D or QH % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    G = QH // KH
    if T * G > MAX_VERIFY_ROWS:
        raise ValueError(
            f"{T} fed tokens x GQA group {G} = {T * G} query rows > {MAX_VERIFY_ROWS}")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    qdt, ndt, odt = _io_dtypes(dt)
    qc = q.to(qdt).contiguous()
    k_new = k_new.to(ndt).contiguous()
    v_new = v_new.to(ndt).contiguous()
    ks = _scales_arg(k_scales, dt, L, KH, q.device)
    vs = _scales_arg(v_scales, dt, L, KH, q.device)
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (B, maxp))
    _require(seq_lens, "seq_lens", torch.int32, (B,))
    _require(k_new, "k_new", ndt, (B, T, KH, D))
    _require(v_new, "v_new", ndt, (B, T, KH, D))
    _require(slot_pages, "slot_pages", torch.int32, (B, T))
    _require(slot_offsets, "slot_offsets", torch.int32, (B, T))
    _require_aligned("K4", qc, k_new, v_new, k_pool, v_pool)
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty(qc.shape, dtype=odt, device=q.device)
    # per-split partials (max, sum, acc) of each query row
    splits = max(-(-maxp * TP // VERIFY_SPLIT), 1)
    scratch = torch.empty(B * KH * splits * T * G * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load(_build.lib_name("paged_verify", D))
    rc = lib.kvc_paged_verify(
        KERNEL_DTYPES[dt], D, qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), slot_pages.data_ptr(), slot_offsets.data_ptr(),
        _ptr(ks), _ptr(vs), out.data_ptr(), scratch.data_ptr(), B, T, layer, P,
        KH, G, TP, maxp, int(window or 0), float(sm_scale), cap, _stream(q),
    )
    _build.check(rc, "paged_verify")
    _count(paged_attention_verify, dt, cap, D)
    return out.to(q.dtype), k_pool, v_pool


# ---------------------------------------------------------------------------
# K6: prefill page writer of the single (MLA latent) pool
# ---------------------------------------------------------------------------


def write_prefill_kv_single_plain(k_pool, k_new, pages, layer, *, scale=None):
    """Plain PyTorch version of K6 (a byte pool quantizes: ``scale`` is the
    layer's int8 scales [KH])."""
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    keep = pages != 0  # zero page: discard
    sc = None if scale is None or k_pool.dtype != torch.int8 else scale.float()[:, None, None]
    chunks = quantize_kv(k_new, k_pool.dtype, sc).reshape(KH, T // TP, TP, D).transpose(0, 1)
    k_pool[int(layer), pages[keep].long()] = chunks[keep]
    return k_pool


def write_prefill_kv_single(
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    k_new: torch.Tensor,  # [num_kv_heads, T, head_dim]; T multiple of page_tokens
    pages: torch.Tensor,  # [T // page_tokens] int32 physical pages (0 = discard)
    layer,
    *,
    scale=None,  # [num_kv_heads] float32: the layer's int8 scales
) -> torch.Tensor:
    """K6: write a prefill chunk's latent entries into the single pool's
    pages, in place.  Returns ``k_pool``.

    Replaces the Pallas ``_prefill_write_single_kernel``.  A pure copy,
    bound by device-memory bytes: ``csrc/prefill_write.cu``'s K2 kernel
    with one buffer, one block per (page, kv head) slab moving 16-byte
    vectors.  Byte pools: ``k_new`` comes unquantized and the kernel
    quantizes it in the same pass, as the reference's wrapper does before
    its copy (int8 with ``scale``, the latent's K scale, which the
    reference requires; e4m3 by :func:`to_e4m3`'s rule)."""
    _mla_pool(k_pool.dtype)
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    if T % TP:
        raise ValueError(f"prefill length {T} must be a multiple of page_tokens {TP}")
    dt = k_pool.dtype
    if dt == torch.int8:
        if scale is None:
            raise ValueError("int8 pools need the layer's per-head scale")
        if tuple(scale.shape) != (KH,):
            raise ValueError(f"scale must be [KH] = {(KH,)}, got {tuple(scale.shape)}")
    if _on_cpu(k_pool, k_new, pages):
        return write_prefill_kv_single_plain(k_pool, k_new, pages, layer, scale=scale)
    if k_pool.dim() != 5 or not k_pool.is_contiguous():
        raise ValueError(f"k_pool must be a contiguous [L, pages, KH, page_tokens, D], "
                         f"got {tuple(k_pool.shape)}")
    L, P, KHp, _, Dp = k_pool.shape
    if (KHp, Dp) != (KH, D):
        raise ValueError(f"k_new {tuple(k_new.shape)} does not fit the pool {tuple(k_pool.shape)}")
    layer = _layer_index(layer, L)
    n = T // TP
    _require(pages, "pages", torch.int32, (n,))
    lib = _build.load("prefill_write")
    byte = dt in BYTE_DTYPES
    k_new = (k_new.float() if byte else k_new.to(dt)).contiguous()
    _require_aligned("K6", k_new, k_pool)
    if byte:  # K2's quantizing pass without V
        sc = _scales_arg(None if scale is None else scale.reshape(1, KH), dt, 1, KH,
                         k_pool.device)
        rc = lib.kvc_prefill_write_quant(
            KERNEL_DTYPES[dt], k_new.data_ptr(), None, k_pool.data_ptr(), None,
            pages.data_ptr(), _ptr(sc), None, layer, P, KH, n, TP * D, _stream(k_pool))
    else:
        rc = lib.kvc_prefill_write_single(
            k_new.data_ptr(), k_pool.data_ptr(), pages.data_ptr(), layer, P, KH, n,
            TP * D * k_pool.element_size(), _stream(k_pool))
    _build.check(rc, "prefill_write_single")
    _count(write_prefill_kv_single, dt)
    return k_pool


# ---------------------------------------------------------------------------
# K5 (and K3's MLA mode): absorbed latent attention over the single pool
# ---------------------------------------------------------------------------


def _mla_pool(pool_dtype) -> None:
    """The MLA kernels take float32, bf16, int8 and e4m3 latent pools."""
    if pool_dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{pool_dtype} MLA latent pools are not ported yet "
            "(float32, bfloat16, int8, float8_e4m3fn)")


def _mla_mode(k_pool, window=None, k_scales=None, v_scales=None, logit_softcap=None):
    """Refuse what the MLA mode does not port (several kv heads, a window,
    soft-capping, other pool types) and check the int8 scales, [L, 1] each.
    Returns the K scales as the kernels take them (None for other pools):
    they serve the values too, so ``v_scales`` is checked and unused."""
    _unsupported(None, logit_softcap)
    _mla_pool(k_pool.dtype)
    if k_pool.dim() != 5 or k_pool.shape[2] != 1:
        raise NotImplementedError(
            "the MLA mode is ported for one latent pool [L, pages, 1, page_tokens, D], "
            f"got {tuple(k_pool.shape)}")
    if window:
        raise NotImplementedError("a window in the MLA mode is not ported yet")
    L = k_pool.shape[0]
    _scales_arg(v_scales, k_pool.dtype, L, 1, k_pool.device)
    return _scales_arg(k_scales, k_pool.dtype, L, 1, k_pool.device)


def _mla_tiles(rows: int, dtype) -> tuple[int, int]:
    """(query tiles, rows a tile) of ``rows`` query rows over a ``dtype``
    latent pool: tensor-core blocks (bf16 and byte pools) hold up to 64
    rows in m-tiles of 16, spread evenly over the tiles; float32 blocks
    hold 16."""
    cap = MLA_ROWS[dtype]
    tiles = -(-rows // cap)
    return tiles, 16 * -(-(-(-rows // tiles)) // 16)


@functools.lru_cache(maxsize=None)
def mla_wave_blocks(device: torch.device, dtype, qrows: int) -> int:
    """Blocks of the MLA attention pass (``qrows`` query rows a block) that
    ``device`` runs at once, as the CUDA occupancy API gives them."""
    lib = _build.load("mla_attend")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.kvc_mla_wave_blocks(KERNEL_DTYPES[dtype], qrows, ctypes.byref(blocks))
    _build.check(rc, "mla_wave_blocks")
    return max(blocks.value, 1)


def mla_attend_launch(q, pool, page_tables, q_starts, kv_lens, layer, *,
                      sm_scale=None, mla_v_dim=MLA_V_DIM, k_new=None,
                      slot_pages=None, slot_offsets=None, split=None, k_scales=None):
    """One call of ``csrc/mla_attend.cu`` on CUDA tensors: optionally store
    the fed latent entries ``k_new`` [N, Tq, 1, D] at their slots, then
    query row r of chunk row n (head r % H of token r // H) attends the
    row's latent entries.  ``q`` [N, Tq, H, D]; ``q_starts`` None means a
    decode/verify row, whose first query sits at ``kv_lens - Tq``.  Keys
    are split into blocks of ``split`` (None: a split-K pass sized to fill
    the card, merged by a third launch; prefill passes the table width, a
    single split).  Byte pools take bf16 q, float32 entries (quantized in
    the kernel) and an int8 pool its ``k_scales`` [L, 1].  Returns
    ``[N, Tq, H, D]`` in the pool's type (float32 for byte pools), lanes
    past ``mla_v_dim`` zero."""
    if pool.dim() != 5 or not pool.is_contiguous():
        raise ValueError(f"the latent pool must be a contiguous [L, pages, 1, page_tokens, D], "
                         f"got {tuple(pool.shape)}")
    L, P, KH, TP, D = pool.shape
    N, Tq, H, Dq = q.shape
    if KH != 1 or D != MLA_HEAD_DIM or Dq != D or mla_v_dim != MLA_V_DIM:
        raise ValueError(
            f"the MLA kernels take one latent pool of {MLA_HEAD_DIM} lanes with "
            f"{MLA_V_DIM} value lanes: q {tuple(q.shape)}, pool {tuple(pool.shape)}, "
            f"mla_v_dim {mla_v_dim}")
    layer = _layer_index(layer, L)
    dt = pool.dtype
    qdt, ndt, odt = _io_dtypes(dt)
    qc = q.to(qdt).contiguous()
    ks = _scales_arg(k_scales, dt, L, 1, q.device)
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (N, maxp))
    _require(kv_lens, "kv_lens", torch.int32, (N,))
    if q_starts is not None:
        _require(q_starts, "q_starts", torch.int32, (N,))
    ptrs = (None, None, None)
    if k_new is not None:
        k_new = k_new.to(ndt).contiguous()
        _require(k_new, "k_new", ndt, (N, Tq, 1, D))
        _require(slot_pages, "slot_pages", torch.int32, (N, Tq))
        _require(slot_offsets, "slot_offsets", torch.int32, (N, Tq))
        _require_aligned("K5", k_new)
        ptrs = (k_new.data_ptr(), slot_pages.data_ptr(), slot_offsets.data_ptr())
    _require_aligned("the MLA kernels", qc, pool)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    rows = Tq * H
    tiles, qrows = _mla_tiles(rows, dt)
    width = maxp * TP
    if split is None:
        # one wave of blocks for the card, but no block under MLA_MIN_SPLIT keys
        per_row = max(1, -(-mla_wave_blocks(q.device, dt, qrows) // (N * tiles)))
        split = max(MLA_MIN_SPLIT, -(-width // per_row))
    split = -(-max(split, 1) // MLA_KEY_TILE) * MLA_KEY_TILE
    splits = max(-(-width // split), 1)
    out = torch.empty(qc.shape, dtype=odt, device=q.device)
    # per-split partials (acc [R], max, sum) of each query row
    scratch = torch.empty(N * splits * rows * (MLA_V_DIM + 2) if splits > 1 else 0,
                          dtype=torch.float32, device=q.device)
    lib = _build.load("mla_attend")
    rc = lib.kvc_mla_attend(
        KERNEL_DTYPES[dt], qc.data_ptr(), pool.data_ptr(), page_tables.data_ptr(),
        None if q_starts is None else q_starts.data_ptr(), kv_lens.data_ptr(),
        *ptrs, _ptr(ks), out.data_ptr(), scratch.data_ptr() if splits > 1 else None,
        N, Tq, H, layer, P, TP, maxp, qrows, split, float(sm_scale), _stream(q),
    )
    _build.check(rc, "mla_attend")
    return out


def paged_attention_decode_mla(q, k_pool, page_tables, seq_lens, layer, k_new,
                               slot_pages, slot_offsets, *, sm_scale=None,
                               mla_v_dim=MLA_V_DIM, k_scales=None):
    """K5, decode form, on CUDA tensors: the kernel behind
    ``paged_attention_decode(..., mla_v_dim=...)``.  q [B, H, D], k_new
    [B, 1, D], slots [B]; returns [B, H, D] in q's type.

    Replaces the Pallas ``_decode_write_kernel_mla``.  Bound by
    device-memory bytes (each latent entry is read once for all H heads,
    ~29 FLOPs a byte at H=16 on a bf16 pool, twice that on a byte pool);
    ``csrc/mla_attend.cu`` stores the token, splits each row's keys over
    blocks and merges their partials."""
    out = mla_attend_launch(
        q[:, None], k_pool, page_tables, None, seq_lens, layer, sm_scale=sm_scale,
        mla_v_dim=mla_v_dim, k_new=k_new[:, None], slot_pages=slot_pages[:, None],
        slot_offsets=slot_offsets[:, None], k_scales=k_scales)
    _count(paged_attention_decode_mla, k_pool.dtype)
    return out[:, 0].to(q.dtype)


def paged_attention_verify_mla(q, k_pool, page_tables, seq_lens, layer, k_new,
                               slot_pages, slot_offsets, *, sm_scale=None,
                               mla_v_dim=MLA_V_DIM, k_scales=None):
    """K5, verify form, on CUDA tensors: the kernel behind
    ``paged_attention_verify(..., mla_v_dim=...)``.  q [B, T, H, D], k_new
    [B, T, 1, D], slots [B, T]; returns [B, T, H, D] in q's type.

    Replaces the Pallas ``_verify_write_kernel_mla``: decode with T fed
    tokens, whose T*H query rows (80 at T=5, H=16) are tiled over blocks
    of at most 64."""
    out = mla_attend_launch(
        q, k_pool, page_tables, None, seq_lens, layer, sm_scale=sm_scale,
        mla_v_dim=mla_v_dim, k_new=k_new, slot_pages=slot_pages,
        slot_offsets=slot_offsets, k_scales=k_scales)
    _count(paged_attention_verify_mla, k_pool.dtype)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K7 / K8: one decode token per (kv layer, row), the dp-replica equalizer
# ---------------------------------------------------------------------------


def _token_scales(scales, pool_dtype, L, Lk):
    """(int8 scales as the writers take them, keyed by kv layer?): [L, KH]
    keyed by pool layer, or [Lk, KH] keyed by kv layer when that is their
    row count and ``Lk != L`` (the reference's rule: a hybrid arena's
    per-model-layer scales).  None for other pools."""
    if scales is None or pool_dtype != torch.int8:
        return None, False
    by_kv = scales.shape[0] == Lk and Lk != L
    return scales.float(), by_kv


def write_decode_tokens_plain(k_pool, v_pool, k_new, v_new, pool_layers, slot_pages,
                              slot_offsets, *, k_scales=None, v_scales=None):
    """Plain PyTorch version of K7 (``v_pool`` None: K8): each kv layer's
    tokens through :func:`_write_slots`, the fused kernels' own store."""
    L, Lk = k_pool.shape[0], k_new.shape[0]
    ks, by_kv = _token_scales(k_scales, k_pool.dtype, L, Lk)
    vs, _ = _token_scales(v_scales, k_pool.dtype, L, Lk)
    for li, layer in enumerate(pool_layers.tolist()):
        row = li if by_kv else layer
        _write_slots(k_pool, layer, k_new[li], slot_pages[li], slot_offsets,
                     None if ks is None else ks[row])
        if v_pool is not None:
            _write_slots(v_pool, layer, v_new[li], slot_pages[li], slot_offsets,
                         None if vs is None else vs[row])
    return k_pool, v_pool


def write_decode_tokens_single_plain(k_pool, k_new, pool_layers, slot_pages, slot_offsets,
                                     *, k_scales=None):
    """Plain PyTorch version of K8."""
    return write_decode_tokens_plain(k_pool, None, k_new, None, pool_layers, slot_pages,
                                     slot_offsets, k_scales=k_scales)[0]


def _decode_tokens_launch(wrapper, k_pool, v_pool, k_new, v_new, pool_layers, slot_pages,
                          slot_offsets, k_scales, v_scales):
    """Check the CUDA tensors and launch ``csrc/decode_tokens_write.cu``
    (``v_pool`` None: K8)."""
    pools = (k_pool,) if v_pool is None else (k_pool, v_pool)
    if k_pool.dim() != 5 or not k_pool.is_contiguous():
        raise ValueError(f"pools must be contiguous [L, pages, KH, page_tokens, D], "
                         f"got {tuple(k_pool.shape)}")
    if v_pool is not None:
        _require(v_pool, "v_pool", k_pool.dtype, k_pool.shape)
    L, P, KH, TP, D = k_pool.shape
    dt = k_pool.dtype
    byte = dt in BYTE_DTYPES
    if (D * k_pool.element_size()) % 16 or (byte and D % 16):
        raise ValueError(f"head_dim {D} does not fill whole 16-byte vectors of a {dt} pool")
    Lk, B = k_new.shape[:2]
    # byte pools: the bf16 model's tokens as they are (the kernel widens
    # them), any other type as float32
    ndt = (torch.bfloat16 if k_new.dtype == torch.bfloat16 else torch.float32) if byte else dt
    news = [t.to(ndt).contiguous() for t in (k_new, v_new) if t is not None]
    for t, name in zip(news, ("k_new", "v_new")):
        _require(t, name, ndt, (Lk, B, KH, D))
    if len(news) != len(pools):
        raise ValueError("v_new and v_pool go together")
    _require(pool_layers, "pool_layers", torch.int32, (Lk,))
    _require(slot_pages, "slot_pages", torch.int32, (Lk, B))
    _require(slot_offsets, "slot_offsets", torch.int32, (B,))
    if dt == torch.int8 and (k_scales is None or (v_pool is not None and v_scales is None)):
        raise ValueError("int8 pools need their per-head scales")
    ks, by_kv = _token_scales(k_scales, dt, L, Lk)
    vs, _ = _token_scales(v_scales, dt, L, Lk)
    rows = Lk if by_kv else L
    ks, vs = (None if s is None else _scales_arg(s, dt, rows, KH, k_pool.device)
              for s in (ks, vs if v_pool is not None else None))
    _require_aligned("K7" if v_pool is not None else "K8", *news, *pools)
    lib = _build.load("decode_tokens_write")
    rc = lib.kvc_decode_tokens_write(
        KERNEL_DTYPES[dt], int(ndt == torch.bfloat16 and byte), news[0].data_ptr(), _ptr(news[1] if v_pool is not None else None),
        k_pool.data_ptr(), _ptr(v_pool), pool_layers.data_ptr(), slot_pages.data_ptr(),
        slot_offsets.data_ptr(), _ptr(ks), _ptr(vs), Lk, B, L, P, KH, TP, D, int(by_kv),
        _stream(k_pool))
    _build.check(rc, "decode_tokens_write")
    _count(wrapper, dt, head_dim=D if D in KERNEL_HEAD_DIM else KERNEL_HEAD_DIM[0])


def write_decode_tokens(
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [Lk, B, num_kv_heads, head_dim] unquantized
    v_new: torch.Tensor,
    pool_layers: torch.Tensor,  # [Lk] int32 pool layer of each kv layer
    slot_pages: torch.Tensor,  # [Lk, B] int32 physical page (0 = discard)
    slot_offsets: torch.Tensor,  # [B] int32 slot within the page
    *,
    k_scales=None,  # int8: [L, KH], or [Lk, KH] keyed by kv layer
    v_scales=None,
):
    """K7: store one decode token per (kv layer, row) into the pools, in
    place.  Returns ``(k_pool, v_pool)``.

    Replaces the Pallas ``_decode_tokens_write_kernel``: the dp-replica
    equalizer, which after each step stores every row's token into every
    replica's pool.  A slot the fused kernels (K1, K4) already wrote keeps
    its bytes: float32 and bf16 tokens are cast to the pool's type, byte
    pools quantize as the fused kernels do.  ``pool_layers`` maps kv layers
    to pool layers (the identity, or a hybrid arena's ``layer_in_group``).
    int8 pools need the scales; they are keyed by kv layer when their row
    count is ``Lk != L``, as the reference keys them.  Bound by
    device-memory bytes; ``csrc/decode_tokens_write.cu`` gives each (row,
    kv layer) one block moving its KH x D values as 16-byte vectors."""
    _unsupported(pool_dtype=k_pool.dtype)
    if _on_cpu(k_pool, v_pool, k_new, v_new, pool_layers, slot_pages, slot_offsets):
        if k_pool.dtype == torch.int8 and (k_scales is None or v_scales is None):
            raise ValueError("int8 pools need their per-head scales")
        return write_decode_tokens_plain(k_pool, v_pool, k_new, v_new, pool_layers,
                                         slot_pages, slot_offsets, k_scales=k_scales,
                                         v_scales=v_scales)
    _decode_tokens_launch(write_decode_tokens, k_pool, v_pool, k_new, v_new, pool_layers,
                          slot_pages, slot_offsets, k_scales, v_scales)
    return k_pool, v_pool


def write_decode_tokens_single(
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    k_new: torch.Tensor,  # [Lk, B, num_kv_heads, head_dim] unquantized
    pool_layers: torch.Tensor,  # [Lk] int32
    slot_pages: torch.Tensor,  # [Lk, B] int32 (0 = discard)
    slot_offsets: torch.Tensor,  # [B] int32
    *,
    k_scales=None,  # int8: [L, KH]
) -> torch.Tensor:
    """K8: :func:`write_decode_tokens` for one buffer, the MLA latent pool
    (one kv head of 640 lanes).  Returns ``k_pool``.

    Replaces the Pallas ``_decode_tokens_write_single_kernel``: the same
    CUDA kernel without V."""
    _mla_pool(k_pool.dtype)
    if _on_cpu(k_pool, k_new, pool_layers, slot_pages, slot_offsets):
        if k_pool.dtype == torch.int8 and k_scales is None:
            raise ValueError("int8 pools need their per-head scales")
        return write_decode_tokens_single_plain(k_pool, k_new, pool_layers, slot_pages,
                                                slot_offsets, k_scales=k_scales)
    _decode_tokens_launch(write_decode_tokens_single, k_pool, None, k_new, None, pool_layers,
                          slot_pages, slot_offsets, k_scales, None)
    return k_pool


for _wrapper in (paged_attention_decode, paged_attention, write_prefill_kv,
                 paged_attention_verify, write_prefill_kv_single,
                 paged_attention_decode_mla, paged_attention_verify_mla,
                 write_decode_tokens, write_decode_tokens_single):
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = {}


# ---------------------------------------------------------------------------
# Dense reference (tests).
# ---------------------------------------------------------------------------


def paged_attention_reference(
    q, k_pool, v_pool, page_tables, seq_lens, *,
    sm_scale: float | None = None, logit_softcap: float | None = None,
):
    """Dense float32 oracle of paged decode attention (no window), the
    counterpart of the JAX package's ``paged_attention_reference``."""
    batch, num_q_heads, head_dim = q.shape
    if k_pool.dim() == 5:
        k_pool, v_pool = k_pool[0], v_pool[0]
    num_kv_heads = k_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    k = _gather_pages(k_pool, page_tables)
    v = _gather_pages(v_pool, page_tables)
    qg = q.reshape(batch, num_kv_heads, -1, head_dim).float()
    s = torch.matmul(qg, k.transpose(-1, -2)) * sm_scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = torch.arange(k.shape[2], device=q.device)[None, None, None, :] \
        < seq_lens.long()[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o.reshape(batch, num_q_heads, head_dim).to(q.dtype)
