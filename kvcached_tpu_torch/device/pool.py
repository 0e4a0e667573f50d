"""Device page pool: preallocated KV arenas behind int32 page tables.

Port of ``kvcached_tpu/device/pool.py``.  The layout is the reference's,
so pools can be compared with it element by element after identical writes:

    [num_layers, num_pages, num_kv_heads, page_tokens, head_dim]

- One physical page id indexes dim 1 and is valid across all layers.
- Physical page 0 is the zero page: never handed out, zero-filled, and the
  kernels discard writes aimed at it.
- The free list is host bookkeeping (a deque of page ids); the kernels see
  physical ids only.

The pools are updated **in place**: where the JAX package donated the pool
to a jitted step and got a new array back, the port's kernels and
:func:`write_kv_pages` write into the same ``torch`` tensors, which never
move or get copied.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Sequence

import torch

from ..config import KVConfig
from ..logging_utils import get_kvcached_logger

logger = get_kvcached_logger(__name__)

_KV_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name) -> torch.dtype:
    """KV / model dtype name (the JAX package's spelling) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _KV_DTYPES[str(name)]
    except KeyError as e:
        raise ValueError(f"unsupported dtype {name!r}") from e


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    ``None`` means ``cuda``; a CUDA device without a usable card raises
    instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def hbm_free_bytes(device=None) -> int | None:
    """Free device memory, the ``cudaMemGetInfo`` reading the reference
    sizes its pool from.  None on the CPU (callers size the pool
    explicitly there)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free)


@dataclass(frozen=True)
class PoolSpec:
    """Concrete device-pool geometry derived from a model's KVConfig."""

    num_layers: int
    num_pages: int  # physical pages incl. the zero page (id 0)
    num_kv_heads: int
    page_tokens: int
    head_dim: int
    dtype: torch.dtype
    num_kv_buffers: int = 2

    @property
    def page_bytes(self) -> int:
        """Bytes one physical page consumes across all layers and buffers."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (
            self.num_layers
            * self.num_kv_buffers
            * self.num_kv_heads
            * self.page_tokens
            * self.head_dim
            * itemsize
        )

    @property
    def kv_shape(self) -> tuple[int, ...]:
        return (
            self.num_layers,
            self.num_pages,
            self.num_kv_heads,
            self.page_tokens,
            self.head_dim,
        )

    @classmethod
    def from_config(
        cls,
        cfg: KVConfig,
        *,
        num_pages: int | None = None,
        hbm_budget_bytes: int | None = None,
    ) -> "PoolSpec":
        dt = torch_dtype(cfg.kv_dtype)
        if num_pages is None:
            assert hbm_budget_bytes is not None, "need num_pages or hbm budget"
            probe = cls(
                num_layers=cfg.num_layers,
                num_pages=1,
                num_kv_heads=cfg.num_kv_heads,
                page_tokens=cfg.page_tokens,
                head_dim=cfg.head_dim,
                dtype=dt,
                num_kv_buffers=cfg.num_kv_buffers,
            )
            num_pages = max(2, hbm_budget_bytes // probe.page_bytes)
        return cls(
            num_layers=cfg.num_layers,
            num_pages=num_pages,
            num_kv_heads=cfg.num_kv_heads,
            page_tokens=cfg.page_tokens,
            head_dim=cfg.head_dim,
            dtype=dt,
            num_kv_buffers=cfg.num_kv_buffers,
        )


class DevicePagePool:
    """Physical-page arena + free list (implements ``PhysicalBackend``).

    The free list is a host deque of physical page ids; the tensors are
    zero-filled on ``device`` so the zero page reads as zeros."""

    def __init__(self, spec: PoolSpec, *, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self._free = deque(range(1, spec.num_pages))
        self._lock = threading.Lock()

    # -- PhysicalBackend protocol -------------------------------------------

    @property
    def capacity(self) -> int:
        return self.spec.num_pages

    def acquire(self, n: int) -> list[int] | None:
        with self._lock:
            if len(self._free) < n:
                return None
            return [self._free.popleft() for _ in range(n)]

    def release(self, page_ids: Sequence[int]) -> None:
        with self._lock:
            for p in page_ids:
                assert p != 0, "cannot release the zero page"
                self._free.append(p)

    def avail_physical_pages(self) -> int:
        with self._lock:
            return len(self._free)

    # -- device tensors -----------------------------------------------------

    def allocate_arrays(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Create the zero-filled K (and V) pool tensors on the device."""
        shape = self.spec.kv_shape
        k = torch.zeros(shape, dtype=self.spec.dtype, device=self.device)
        v = (
            torch.zeros(shape, dtype=self.spec.dtype, device=self.device)
            if self.spec.num_kv_buffers == 2
            else None
        )
        logger.info(
            "allocated KV pool: %s pages × %d B/page = %.2f GB (%s, %s)",
            self.spec.num_pages,
            self.spec.page_bytes,
            self.spec.num_pages * self.spec.page_bytes / 1e9,
            self.spec.dtype,
            self.device,
        )
        return k, v


def write_kv_pages(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    layer: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pages: torch.Tensor,
    slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new KV for T tokens into their (page, slot) positions, in
    place (``index_put_``).

    k_new/v_new: [T, num_kv_heads, head_dim]; pages/slots: [T] int.
    Out-of-range pages are dropped, like the reference's ``mode="drop"``.
    Returns the (same) pool tensors."""
    keep = (pages >= 0) & (pages < k_pool.shape[1])
    pages, slots = pages[keep].long(), slots[keep].long()
    heads = torch.arange(k_pool.shape[2], device=k_pool.device)
    idx = (pages[:, None], heads[None, :], slots[:, None])
    k_pool[layer].index_put_(idx, k_new[keep].to(k_pool.dtype))  # a view: in place
    v_pool[layer].index_put_(idx, v_new[keep].to(v_pool.dtype))
    return k_pool, v_pool
