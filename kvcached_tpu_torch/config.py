"""Configuration and environment-variable surface for kvcached-tpu.

Functional parity with the reference's env-knob surface (see reference
``kvcached/utils.py:95-177`` and ``csrc/page_allocator.cpp:24-37``), redesigned
for TPU: pages are measured in *tokens per layer* rather than driver-granule
bytes, because on TPU a "page" is a slot in a preallocated HBM pool tensor and
"mapping" is page-table metadata, not a VMM call.

All knobs are parsed once at import; misconfiguration that the user must fix
raises :class:`KVCachedConfigError` loudly instead of silently falling back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


class KVCachedConfigError(Exception):
    """User-fixable misconfiguration: abort loudly, never fall back silently.

    Mirrors the reference's ``KVCachedConfigError`` (kvcached/utils.py:9-12).
    """


def _env_bool(name: str, default: bool) -> bool:
    v = os.getenv(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError as e:
        raise KVCachedConfigError(f"{name} must be an integer, got {v!r}") from e


def _env_float(name: str, default: float) -> float:
    v = os.getenv(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError as e:
        raise KVCachedConfigError(f"{name} must be a float, got {v!r}") from e


# ---------------------------------------------------------------------------
# Global env knobs (parsed once; import-time).
# ---------------------------------------------------------------------------

#: Master switch (reference: ENABLE_KVCACHED).
ENABLE_KVCACHED: bool = _env_bool("ENABLE_KVCACHED", True)

#: Tokens per page per layer per K/V buffer. The TPU analogue of
#: KVCACHED_PAGE_SIZE_MB: a page is ``page_tokens`` KV slots in the pool.
#: Must be a multiple of 8 for TPU sublane alignment of fp32 and a multiple
#: of the block size (validated in KVConfig).
PAGE_TOKENS: int = _env_int("KVCACHED_PAGE_TOKENS", 64)

#: Fraction of free HBM the pool may claim at init (reference:
#: KVCACHED_GPU_UTILIZATION=0.95).
HBM_UTILIZATION: float = _env_float("KVCACHED_HBM_UTILIZATION", 0.9)

#: Keep between MIN and MAX pages pre-assigned ("pre-mapped") by the
#: prealloc thread so page assignment stays off the decode critical path
#: (reference: KVCACHED_MIN/MAX_RESERVED_PAGES = 5/10).
PAGE_PREALLOC_ENABLED: bool = _env_bool("KVCACHED_PAGE_PREALLOC_ENABLED", True)
MIN_RESERVED_PAGES: int = _env_int("KVCACHED_MIN_RESERVED_PAGES", 5)
MAX_RESERVED_PAGES: int = _env_int("KVCACHED_MAX_RESERVED_PAGES", 10)

#: Prefix-cache bound: max tokens retained in the evictable pool.
#: <0 = unlimited, 0 = disabled (reference: KVCACHED_MAX_CACHED_TOKENS=16000).
MAX_CACHED_TOKENS: int = _env_int("KVCACHED_MAX_CACHED_TOKENS", 16000)

#: Opt-in invariant checking on the hot path (reference: KVCACHED_SANITY_CHECK).
SANITY_CHECK: bool = _env_bool("KVCACHED_SANITY_CHECK", False)

#: Resize-watcher poll interval in milliseconds (reference hardcodes 100 ms).
RESIZE_POLL_MS: int = _env_int("KVCACHED_RESIZE_POLL_MS", 100)

#: Force the pure-Python allocator core even if the native library is built.
FORCE_PYTHON_CORE: bool = _env_bool("KVCACHED_FORCE_PYTHON_CORE", False)

#: Override for the shm control-plane segment name (reference: KVCACHED_IPC_NAME).
IPC_NAME_ENV: str | None = os.getenv("KVCACHED_IPC_NAME")

SHM_DIR: str = os.getenv("KVCACHED_SHM_DIR", "/dev/shm")


def default_ipc_name(instance: str | None = None) -> str:
    """Derive the control-plane segment name.

    Reference derives ``kvcached_<Engine>_<PGID>`` (kvcached/utils.py:46-92);
    we use ``kvcached_tpu_<instance-or-pgid>``.
    """
    if IPC_NAME_ENV:
        base = IPC_NAME_ENV
    elif instance:
        base = f"kvcached_tpu_{instance}"
    else:
        base = f"kvcached_tpu_{os.getpgid(0)}"
    return base


def validate_page_geometry(page_tokens: int, block_tokens: int) -> None:
    """A block must pack exactly into a page.

    The reference allows blocks to straddle nothing (a block must fit in one
    page, kv_cache_manager.py:104-116) and skips straddling block ids.  On TPU
    we control both sizes, so we demand exact divisibility — simpler
    bookkeeping and zero wasted slots.
    """
    if block_tokens <= 0 or page_tokens <= 0:
        raise KVCachedConfigError(
            f"page_tokens ({page_tokens}) and block_tokens ({block_tokens}) must be > 0"
        )
    if page_tokens % block_tokens != 0:
        raise KVCachedConfigError(
            f"page_tokens ({page_tokens}) must be a multiple of block_tokens "
            f"({block_tokens}); choose sizes so blocks pack exactly into pages"
        )
    if page_tokens % 8 != 0:
        raise KVCachedConfigError(
            f"page_tokens ({page_tokens}) must be a multiple of 8 for TPU "
            f"sublane alignment"
        )


@dataclass(frozen=True)
class KVConfig:
    """Static geometry of one KV pool group.

    The TPU translation of the reference's per-group FTensor geometry
    (csrc/allocator.cpp:121-153): instead of virtual-address tensors we have
    one preallocated pool of ``num_pages`` pages, each holding
    ``page_tokens`` KV slots for every layer and K/V buffer simultaneously —
    a single logical page id backs one token-range across *all* layers, so a
    "map" is one metadata write (the contiguous layout's +1-call boot speed)
    while the pool's memory layout keeps each layer dense (the per-layer
    layout's locality; see reference bench_layout −31% lesson).
    """

    num_layers: int
    num_kv_heads: int
    head_dim: int
    block_tokens: int = 16
    page_tokens: int = PAGE_TOKENS
    num_kv_buffers: int = 2  # 2 = K and V; 1 = MLA combined buffer
    kv_dtype: str = "bfloat16"
    group_id: int = 0

    def __post_init__(self) -> None:
        validate_page_geometry(self.page_tokens, self.block_tokens)
        if self.num_layers <= 0 or self.num_kv_heads <= 0 or self.head_dim <= 0:
            raise KVCachedConfigError("num_layers/num_kv_heads/head_dim must be > 0")
        if self.num_kv_buffers not in (1, 2):
            raise KVCachedConfigError("num_kv_buffers must be 1 (MLA) or 2 (K+V)")
        if self.dtype_itemsize == 1 and self.page_tokens % 32 != 0:
            raise KVCachedConfigError(
                f"byte-width KV dtypes ({self.kv_dtype}) need page_tokens to "
                f"be a multiple of 32 (TPU packed-tile granule), got "
                f"{self.page_tokens}"
            )

    @property
    def blocks_per_page(self) -> int:
        return self.page_tokens // self.block_tokens

    @property
    def dtype_itemsize(self) -> int:
        import numpy as np

        return np.dtype(
            {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}.get(
                self.kv_dtype, self.kv_dtype
            )
        ).itemsize

    @property
    def cell_bytes(self) -> int:
        """Bytes of one token's K (or V) in one layer (reference 'cell')."""
        return self.num_kv_heads * self.head_dim * self.dtype_itemsize

    @property
    def page_bytes(self) -> int:
        """Bytes one page consumes across all layers and KV buffers."""
        return self.page_tokens * self.cell_bytes * self.num_layers * self.num_kv_buffers

    @property
    def block_bytes(self) -> int:
        return self.block_tokens * self.cell_bytes * self.num_layers * self.num_kv_buffers

    def num_pages_for_bytes(self, nbytes: int) -> int:
        return max(0, nbytes // self.page_bytes)
