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

Each wrapper launches its hand-written CUDA kernel (``csrc/paged_decode.cu``,
``csrc/prefill_write.cu``, ``csrc/paged_verify.cu``) on
``torch.cuda.current_stream()`` when given CUDA
tensors, and runs the plain PyTorch version beside it (``*_plain``) only
when given CPU tensors.  There is no fallback: a CUDA call that the kernel
does not take raises.  The pools are updated in place and returned, where
the JAX package donated them and got new arrays back.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``.

The kernels take float32 and bfloat16 pools with head_dim 128.  int8 and fp8
pools, logit soft-capping and the MLA single-buffer mode raise
``NotImplementedError``: they are not ported yet.
"""

from __future__ import annotations

import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 128
MAX_GQA_GROUP = 16
#: tokens per block of K1's split-K pass (csrc/paged_decode.cu SPLIT)
DECODE_SPLIT = 256
#: tokens per block of K4's split-K pass (csrc/paged_verify.cu SPLIT)
VERIFY_SPLIT = 256
#: query rows (fed tokens x GQA group) one K4 block holds (csrc/paged_verify.cu ROWS)
MAX_VERIFY_ROWS = 64


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------


def _unsupported(mla_v_dim=None, k_scales=None, v_scales=None,
                 logit_softcap=None, pool_dtype=None) -> None:
    if mla_v_dim is not None:
        raise NotImplementedError("the MLA single-buffer mode is not ported yet")
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("int8 KV scales are not ported yet")
    if logit_softcap is not None:
        raise NotImplementedError("logit soft-capping is not ported yet")
    if pool_dtype is not None and pool_dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{pool_dtype} pools are not ported yet (float32, bfloat16 only)")


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
    if D != KERNEL_HEAD_DIM:
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


def _masked_softmax_pv(s, valid, v, op_dtype):
    """Softmax over the last axis of float32 scores ``s`` restricted to
    ``valid``, times float32 values ``v``: the function every flash loop of
    the kernels computes.  The weights are rounded to the operand type
    before they multiply V (bf16 pools), and a row with nothing valid
    yields zeros."""
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(_op_round(p, op_dtype), v)
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


def paged_attention_decode_plain(
    q, k_pool, v_pool, page_tables, seq_lens, layer,
    k_new, v_new, slot_pages, slot_offsets,
    *, sm_scale=None, window=None, write_kv=True,
):
    """Plain PyTorch version of K1 (``write_kv=True``) and K1r: the same
    function as the CUDA kernel, in dense tensor ops."""
    B, QH, D = q.shape
    KH = k_pool.shape[2]
    G = QH // KH
    dt = k_pool.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    layer = int(layer)
    if write_kv:
        keep = slot_pages != 0  # zero page: discard
        pages, offs = slot_pages[keep].long(), slot_offsets[keep].long()
        k_pool[layer, pages, :, offs] = k_new[keep].to(dt)
        v_pool[layer, pages, :, offs] = v_new[keep].to(dt)
    k = _gather_pages(k_pool[layer], page_tables)
    v = _gather_pages(v_pool[layer], page_tables)
    qg = _op_round(q.reshape(B, KH, G, D), dt)
    s = torch.matmul(qg, k.transpose(-1, -2)) * sm_scale  # [B, KH, G, S]
    pos = torch.arange(k.shape[2], device=q.device)[None]
    sl = seq_lens.long()[:, None]
    valid = pos < sl
    if window:
        valid = valid & (pos >= (sl - window).clamp(min=0))
    o = _masked_softmax_pv(s, valid[:, None, None, :], v, dt)
    return o.reshape(B, QH, D).to(dt).to(q.dtype), k_pool, v_pool


def _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer, k_new,
                   v_new, slot_pages, slot_offsets, sm_scale, window, write_kv):
    L, P, KH, TP, D = _require_pools(k_pool, v_pool)
    B, QH, Dq = q.shape
    if Dq != D or QH % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    G = QH // KH
    if G > MAX_GQA_GROUP:
        raise ValueError(f"GQA group {G} > {MAX_GQA_GROUP} is not supported")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    qc = q.to(dt).contiguous()
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (B, maxp))
    _require(seq_lens, "seq_lens", torch.int32, (B,))
    if write_kv:
        k_new = k_new.to(dt).contiguous()
        v_new = v_new.to(dt).contiguous()
        _require(k_new, "k_new", dt, (B, KH, D))
        _require(v_new, "v_new", dt, (B, KH, D))
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
    out = torch.empty_like(qc)
    # per-split partials (max, sum, acc) of the split-K pass
    GT = 4 if G <= 4 else (8 if G <= 8 else 16)
    splits = -(-maxp * TP // DECODE_SPLIT)
    scratch = torch.empty(B * KH * splits * GT * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("paged_decode")
    rc = lib.kvc_paged_decode(
        KERNEL_DTYPES[dt], qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), *ptrs, out.data_ptr(),
        scratch.data_ptr(), B, layer, P, KH, G, TP, maxp, int(window or 0),
        float(sm_scale), int(write_kv), _stream(q),
    )
    _build.check(rc, "paged_decode")
    return out.to(q.dtype)


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
    blocks so that a small batch still fills the SMs, then merges them."""
    _unsupported(mla_v_dim, k_scales, v_scales, logit_softcap, k_pool.dtype)
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens, k_new, v_new,
               slot_pages, slot_offsets):
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, k_new, v_new,
            slot_pages, slot_offsets, sm_scale=sm_scale, window=window)
    out = _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer,
                         k_new, v_new, slot_pages, slot_offsets, sm_scale,
                         window, True)
    paged_attention_decode.launches += 1
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
    write off, bound and design as K1."""
    _unsupported(mla_v_dim, k_scales, v_scales, logit_softcap, k_pool.dtype)
    if k_pool.dim() == 4:
        k_pool, v_pool = k_pool[None], v_pool[None]
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens):
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, None, None,
            None, None, sm_scale=sm_scale, window=window, write_kv=False)[0]
    out = _decode_launch(q, k_pool, v_pool, page_tables, seq_lens, layer,
                         None, None, None, None, sm_scale, window, False)
    paged_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# K2: prefill page writer
# ---------------------------------------------------------------------------


def write_prefill_kv_plain(k_pool, v_pool, k_new, v_new, pages, layer):
    """Plain PyTorch version of K2."""
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    n = T // TP
    layer = int(layer)
    keep = pages != 0  # zero page: discard
    idx = pages[keep].long()
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        chunks = new.to(pool.dtype).reshape(KH, n, TP, D).transpose(0, 1)
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
    head) slab one block that moves it as 16-byte vectors."""
    _unsupported(k_scales=k_scale, v_scales=v_scale, pool_dtype=k_pool.dtype)
    KH, T, D = k_new.shape
    TP = k_pool.shape[3]
    if T % TP:
        raise ValueError(f"prefill length {T} must be a multiple of page_tokens {TP}")
    if _on_cpu(k_pool, v_pool, k_new, v_new, pages):
        return write_prefill_kv_plain(k_pool, v_pool, k_new, v_new, pages, layer)
    L, P, KHp, _, Dp = _require_pools(k_pool, v_pool)
    if (KHp, Dp) != (KH, D):
        raise ValueError(f"k_new {tuple(k_new.shape)} does not fit pools {tuple(k_pool.shape)}")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    k_new = k_new.to(dt).contiguous()
    v_new = v_new.to(dt).contiguous()
    _require(v_new, "v_new", dt, k_new.shape)
    n = T // TP
    _require(pages, "pages", torch.int32, (n,))
    slab = TP * D * k_pool.element_size()
    _require_aligned("K2", k_new, v_new, k_pool, v_pool)
    lib = _build.load("prefill_write")
    rc = lib.kvc_prefill_write(
        k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), pages.data_ptr(), layer, P, KH, n, slab,
        _stream(k_pool),
    )
    _build.check(rc, "prefill_write")
    write_prefill_kv.launches += 1
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# K4: speculative-decode verify (write T fed tokens, causal multi-query attend)
# ---------------------------------------------------------------------------


def paged_attention_verify_plain(
    q, k_pool, v_pool, page_tables, seq_lens, layer,
    k_new, v_new, slot_pages, slot_offsets, *, sm_scale=None, window=None,
):
    """Plain PyTorch version of K4: the same function as the CUDA kernel,
    in dense tensor ops.  Keys past the page-table width do not exist
    (the table is gathered whole), as the kernel clamps its range."""
    B, T, QH, D = q.shape
    KH = k_pool.shape[2]
    G = QH // KH
    dt = k_pool.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    layer = int(layer)
    keep = slot_pages != 0  # zero page: discard
    pages, offs = slot_pages[keep].long(), slot_offsets[keep].long()
    k_pool[layer, pages, :, offs] = k_new[keep].to(dt)
    v_pool[layer, pages, :, offs] = v_new[keep].to(dt)
    k = _gather_pages(k_pool[layer], page_tables)
    v = _gather_pages(v_pool[layer], page_tables)
    # [B, T, KH, G, D] -> [B, KH, T*G, D], row = t * G + g
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 1, 3, 4).reshape(B, KH, T * G, D)
    s = torch.matmul(_op_round(qg, dt), k.transpose(-1, -2)) * sm_scale
    pos = torch.arange(k.shape[2], device=q.device)[None, None]
    # query row r = t*G + g sits at seq_len - T + t and sees keys below
    # seq_len - T + t + 1
    limit = seq_lens.long()[:, None] - T + torch.arange(T, device=q.device)[None] + 1
    limit = limit.repeat_interleave(G, dim=1)[:, :, None]  # [B, R, 1]
    valid = (pos < limit) & (pos < seq_lens.long()[:, None, None])
    if window:
        valid = valid & (pos >= (limit - window).clamp(min=0))
    o = _masked_softmax_pv(s, valid[:, None], v, dt)  # [B, KH, R, D]
    o = o.reshape(B, KH, T, G, D).permute(0, 2, 1, 3, 4).reshape(B, T, QH, D)
    return o.to(dt).to(q.dtype), k_pool, v_pool


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
    blocks' partials."""
    _unsupported(mla_v_dim, k_scales, v_scales, logit_softcap, k_pool.dtype)
    if _on_cpu(q, k_pool, v_pool, page_tables, seq_lens, k_new, v_new,
               slot_pages, slot_offsets):
        return paged_attention_verify_plain(
            q, k_pool, v_pool, page_tables, seq_lens, layer, k_new, v_new,
            slot_pages, slot_offsets, sm_scale=sm_scale, window=window)
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
    qc = q.to(dt).contiguous()
    k_new = k_new.to(dt).contiguous()
    v_new = v_new.to(dt).contiguous()
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (B, maxp))
    _require(seq_lens, "seq_lens", torch.int32, (B,))
    _require(k_new, "k_new", dt, (B, T, KH, D))
    _require(v_new, "v_new", dt, (B, T, KH, D))
    _require(slot_pages, "slot_pages", torch.int32, (B, T))
    _require(slot_offsets, "slot_offsets", torch.int32, (B, T))
    _require_aligned("K4", qc, k_new, v_new, k_pool, v_pool)
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(qc)
    # per-split partials (max, sum, acc) of each query row
    splits = max(-(-maxp * TP // VERIFY_SPLIT), 1)
    scratch = torch.empty(B * KH * splits * T * G * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("paged_verify")
    rc = lib.kvc_paged_verify(
        KERNEL_DTYPES[dt], qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), slot_pages.data_ptr(), slot_offsets.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, T, layer, P, KH, G, TP, maxp,
        int(window or 0), float(sm_scale), _stream(q),
    )
    _build.check(rc, "paged_verify")
    paged_attention_verify.launches += 1
    return out.to(q.dtype), k_pool, v_pool


paged_attention_decode.launches = 0
paged_attention.launches = 0
write_prefill_kv.launches = 0
paged_attention_verify.launches = 0


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
