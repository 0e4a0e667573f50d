"""Paged prefill (flash) attention, K3.

Port of ``kvcached_tpu/ops/paged_prefill.py``.  Queries are chunks of ``T``
new tokens starting at global position ``q_start``; keys/values come from
the sequence's pages, including pages reused from the prefix cache and the
pages the chunk just wrote.  One code path covers plain prefill
(``q_start = 0``), prefix-cache hits and chunked prefill.

:func:`paged_prefill_attention_batch` launches ``csrc/paged_prefill.cu`` for
CUDA tensors and runs :func:`paged_prefill_attention_batch_plain` for CPU
tensors only; its launches are counted in
``paged_prefill_attention_batch.launches``.  :func:`paged_prefill_attention`
is the N=1 view.  Rows are independent in the kernel, so a batch is
bit-identical to N serial calls; rows with ``kv_len == 0`` give zeros.

Byte pools (int8 with ``k_scales``/``v_scales`` [L, KH], or e4m3) multiply
bf16 operands with float32 accumulation and give the output in q's type,
as in :mod:`.paged_attention`.  ``logit_softcap`` soft-caps the scores
(Gemma2), on every pool type; soft-capped launches are counted under
``"<type>+softcap"``.  head_dim 128 or 256 (a library compiled for each
width), counted under ``"+d256"`` at 256.

The MLA mode (``mla_v_dim``, K3m: the same Pallas kernel over the single
latent pool) launches ``csrc/mla_attend.cu`` through
:func:`paged_prefill_attention_batch_mla`, counted there.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .paged_attention import (
    KERNEL_DTYPES,
    MLA_V_DIM,
    _count,
    _head_scales,
    _io_dtypes,
    _kv_values,
    _layer_index,
    _masked_softmax_pv,
    _mla_mode,
    _mm_dtype,
    _on_cpu,
    _op_round,
    _out,
    _pad_lanes,
    _ptr,
    _require,
    _require_aligned,
    _require_pools,
    _scales_arg,
    _soft_cap,
    _softcap_arg,
    _stream,
    _unsupported,
    mla_attend_launch,
)

#: query rows (token x GQA head) one CUDA block handles; the GQA group
#: must divide it
KERNEL_ROWS = 64


def paged_prefill_attention_batch_plain(
    q, k_pool, v_pool, page_tables, q_starts, kv_lens, layer=0,
    *, sm_scale=None, window=None, mla_v_dim=None, k_scales=None, v_scales=None,
    logit_softcap=None,
):
    """Plain PyTorch version of K3 and, with ``mla_v_dim``, of K3m (values
    from the first ``mla_v_dim`` lanes of ``k_pool``; ``v_pool`` unused).
    int8 pools take ``k_scales``/``v_scales`` [L, KH] (in the MLA mode the
    K scales serve the values too); ``logit_softcap`` caps the scores before
    the mask."""
    N, T, QH, D = q.shape
    KH = k_pool.shape[2]
    G = QH // KH
    dt = k_pool.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    layer = int(layer)
    ksc = _head_scales(k_scales, dt, layer)
    # the MLA mode's values are lanes of the K entries: the K scales serve them
    vsc = ksc if mla_v_dim is not None else _head_scales(v_scales, dt, layer)
    k, v = _kv_values(k_pool, v_pool, layer, page_tables, mla_v_dim)  # [N, KH, S, D]
    # [N, T, QH, D] -> [N, KH, T*G, D] with row r = t*G + g
    mm = _mm_dtype(dt)
    qg = _op_round(
        q.reshape(N, T, KH, G, D).permute(0, 2, 1, 3, 4).reshape(N, KH, T * G, D),
        mm,
    )
    s = torch.matmul(qg, k.transpose(-1, -2)) * sm_scale  # [N, KH, R, S]
    if ksc is not None:
        s = s * ksc[:, None, None]
    s = _soft_cap(s, logit_softcap)
    dev = q.device
    q_pos = q_starts.long()[:, None] + torch.arange(T * G, device=dev)[None] // G
    kv = torch.arange(k.shape[2], device=dev)[None, None, :]
    valid = (kv <= q_pos[:, :, None]) & (kv < kv_lens.long()[:, None, None])
    if window:
        valid = valid & (kv > q_pos[:, :, None] - window)
    o = _masked_softmax_pv(s, valid[:, None], v, mm,
                           None if vsc is None else vsc[:, None, None])
    o = _pad_lanes(o, D)  # [N, KH, R, D]
    o = o.reshape(N, KH, T, G, D).permute(0, 2, 1, 3, 4).reshape(N, T, QH, D)
    return _out(o, dt, q.dtype)


def paged_prefill_attention_batch(
    q: torch.Tensor,  # [N, T, num_q_heads, head_dim]
    k_pool: torch.Tensor,  # [L, num_pages, num_kv_heads, page_tokens, head_dim]
    v_pool: torch.Tensor,
    page_tables: torch.Tensor,  # [N, max_pages] int32 physical pages per row
    q_starts: torch.Tensor,  # [N] int32 global position of each row's q[:, 0]
    kv_lens: torch.Tensor,  # [N] int32 valid tokens (q_start + true chunk len)
    layer=0,
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    mla_v_dim: int | None = None,
    k_scales=None,
    v_scales=None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """K3: causal attention of N prefill chunks against their pages.  The
    chunks' K/V must already be in the pages (:func:`write_prefill_kv`
    runs first).  Returns [N, T, num_q_heads, head_dim].

    Replaces the Pallas ``_prefill_kernel``.  Bound on the card by
    tensor-core operations for long chunks; ``csrc/paged_prefill.cu``
    runs bf16 pools' Q.K^T and P.V on the tensor cores (``mma.sync``,
    64-key tiles in shared memory) and skips key tiles past each block's
    causal limit.

    Byte pools: bf16 q, the K/V widened to bf16 tiles, the int8 scales
    folded into the scores and the output.

    ``logit_softcap``: Gemma2's attention soft-cap, ``cap * tanh(score /
    cap)`` on the scaled scores before the causal mask, on every pool type
    (one ``tanhf`` a score on the CUDA cores, beside the tensor cores'
    products).

    ``mla_v_dim``: K3m, the MLA mode over the single latent pool (values
    its first ``mla_v_dim`` lanes, ``v_pool`` ignored; an int8 latent pool
    takes ``k_scales`` [L, 1], which serve the values too)."""
    if mla_v_dim is not None:
        ks = _mla_mode(k_pool, window, k_scales, v_scales, logit_softcap)
        if _on_cpu(q, k_pool, page_tables, q_starts, kv_lens):
            return paged_prefill_attention_batch_plain(
                q, k_pool, None, page_tables, q_starts, kv_lens, layer,
                sm_scale=sm_scale, mla_v_dim=mla_v_dim, k_scales=ks)
        return paged_prefill_attention_batch_mla(
            q, k_pool, page_tables, q_starts, kv_lens, layer, sm_scale=sm_scale,
            mla_v_dim=mla_v_dim, k_scales=ks)
    _unsupported(pool_dtype=k_pool.dtype)
    cap = _softcap_arg(logit_softcap)
    if _on_cpu(q, k_pool, v_pool, page_tables, q_starts, kv_lens):
        return paged_prefill_attention_batch_plain(
            q, k_pool, v_pool, page_tables, q_starts, kv_lens, layer,
            sm_scale=sm_scale, window=window, k_scales=k_scales, v_scales=v_scales,
            logit_softcap=logit_softcap)
    L, P, KH, TP, D = _require_pools(k_pool, v_pool)
    N, T, QH, Dq = q.shape
    if Dq != D or QH % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    G = QH // KH
    if KERNEL_ROWS % G:
        raise ValueError(f"GQA group {G} must divide {KERNEL_ROWS}")
    layer = _layer_index(layer, L)
    dt = k_pool.dtype
    qdt, _, odt = _io_dtypes(dt)
    qc = q.to(qdt).contiguous()
    ks = _scales_arg(k_scales, dt, L, KH, q.device)
    vs = _scales_arg(v_scales, dt, L, KH, q.device)
    _require_aligned("K3", qc, k_pool, v_pool)
    maxp = page_tables.shape[1]
    _require(page_tables, "page_tables", torch.int32, (N, maxp))
    _require(q_starts, "q_starts", torch.int32, (N,))
    _require(kv_lens, "kv_lens", torch.int32, (N,))
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty(qc.shape, dtype=odt, device=q.device)
    lib = _build.load(_build.lib_name("paged_prefill", D))
    rc = lib.kvc_paged_prefill(
        KERNEL_DTYPES[dt], D, qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), q_starts.data_ptr(), kv_lens.data_ptr(),
        _ptr(ks), _ptr(vs), out.data_ptr(), N, layer, P, KH, G, TP, maxp, T,
        int(window or 0), float(sm_scale), cap, _stream(q),
    )
    _build.check(rc, "paged_prefill")
    _count(paged_prefill_attention_batch, dt, cap, D)
    return out.to(q.dtype)


def paged_prefill_attention_batch_mla(q, k_pool, page_tables, q_starts, kv_lens,
                                      layer=0, *, sm_scale=None, mla_v_dim=MLA_V_DIM,
                                      k_scales=None):
    """K3m on CUDA tensors: the kernel behind
    ``paged_prefill_attention_batch(..., mla_v_dim=...)``.  q [N, T, H, D];
    returns [N, T, H, D] in q's type.

    Replaces the Pallas ``_prefill_kernel`` in MLA mode.  Bound by
    tensor-core operations for long chunks (each latent entry serves
    T*H query rows); ``csrc/mla_attend.cu`` gives each block 64 query rows
    (4 tokens x 16 heads) and all of their keys, up to the block's causal
    limit, in one split."""
    width = page_tables.shape[1] * k_pool.shape[3]
    out = mla_attend_launch(q, k_pool, page_tables, q_starts, kv_lens, layer,
                            sm_scale=sm_scale, mla_v_dim=mla_v_dim, split=width,
                            k_scales=k_scales)
    _count(paged_prefill_attention_batch_mla, k_pool.dtype)
    return out.to(q.dtype)


for _wrapper in (paged_prefill_attention_batch, paged_prefill_attention_batch_mla):
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = {}


def paged_prefill_attention(
    q: torch.Tensor,  # [T, num_q_heads, head_dim]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [max_pages] int32
    q_start,
    kv_len,
    layer=0,
    **kw,
) -> torch.Tensor:
    """N=1 view of :func:`paged_prefill_attention_batch`: [T, QH, D]."""
    dev = q.device
    q_starts = torch.as_tensor(q_start, dtype=torch.int32, device=dev).reshape(1)
    kv_lens = torch.as_tensor(kv_len, dtype=torch.int32, device=dev).reshape(1)
    return paged_prefill_attention_batch(
        q[None], k_pool, v_pool, page_table[None], q_starts, kv_lens, layer, **kw
    )[0]
