"""Engine-facing elastic block allocator.

Functional equivalent of the reference's ``KVCacheManager``
(kvcached/kv_cache_manager.py:60-489) over the TPU page allocator: hands out
*block ids* (``block_tokens`` KV slots across all layers), backed lazily by
physical pages in the shared HBM pool.  Elastic limits imposed through the
shm control plane are honored on the next ``alloc`` (grow immediately,
shrink possibly deferred until frees catch up).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Sequence

from .config import KVConfig, SANITY_CHECK
from .core import PageState, get_page_allocator_cls, group_blocks_by_page
from .core.page_allocator_py import PhysicalBackend
from .locks import make_lock
from .logging_utils import get_kvcached_logger
from .mem_info_tracker import MemInfoTracker

logger = get_kvcached_logger(__name__)


class KVCacheManager:
    """Block allocator for one model instance / KV group.

    Parameters
    ----------
    cfg:
        Pool geometry (layers, heads, dtype, block/page tokens).
    backend:
        Physical page source (shared across colocated models).
    virtual_blocks:
        Size of the block-id space — the analogue of the reference sizing
        FTensors to *total GPU memory* (vllm/interfaces.py:200-219): large
        enough that the engine never sees the physical limit directly.
    ipc_name:
        shm control-plane segment; None disables the operator channel.
    reserve_null_block:
        Keep block 0 permanently allocated as the engine's null/sentinel
        block (reference vllm/patches.py:343-352).
    """

    def __init__(
        self,
        cfg: KVConfig,
        backend: PhysicalBackend,
        *,
        virtual_blocks: int | None = None,
        ipc_name: str | None = None,
        async_sched: bool = False,
        reserve_null_block: bool = True,
        page_table=None,
        map_hook=None,
        unmap_hook=None,
        enable_prealloc: bool | None = None,
    ):
        self.cfg = cfg
        self.blocks_per_page = cfg.blocks_per_page
        if virtual_blocks is None:
            virtual_blocks = backend.capacity * cfg.blocks_per_page
        virtual_pages = -(-virtual_blocks // cfg.blocks_per_page)
        self.num_blocks = virtual_pages * cfg.blocks_per_page

        self._tracker = (
            MemInfoTracker(
                ipc_name,
                group_id=cfg.group_id,
                total_size=virtual_pages * cfg.page_bytes,
            )
            if ipc_name
            else None
        )

        alloc_cls = get_page_allocator_cls()
        self.page_allocator = alloc_cls(
            virtual_pages=virtual_pages,
            blocks_per_page=cfg.blocks_per_page,
            page_bytes=cfg.page_bytes,
            backend=backend,
            page_table=page_table,
            map_hook=map_hook,
            unmap_hook=unmap_hook,
            mem_info_tracker=self._tracker,
            num_layers=cfg.num_layers,
            num_kv_buffers=cfg.num_kv_buffers,
            **({} if enable_prealloc is None else {"enable_prealloc": enable_prealloc}),
        )

        self._lock = make_lock(async_sched)
        # Pages with free blocks, LRU-ish ordered (popitem(last=False)).
        self._avail_pages: OrderedDict[int, PageState] = OrderedDict()
        self._full_pages: dict[int, PageState] = {}
        self._reserved_blocks: list[int] = []  # try_to_reserve pool
        self._in_shrink = False
        self._target_num_blocks: int | None = None

        self.null_block: int | None = None
        if reserve_null_block:
            blocks = self.alloc(1)
            assert blocks is not None and blocks[0] == 0, (
                f"null block must be block 0, got {blocks}"
            )
            self.null_block = blocks[0]

    # ------------------------------------------------------------------ alloc

    def alloc(self, need: int) -> list[int] | None:
        """Allocate ``need`` block ids, or None if the pool can't satisfy it
        (reference kv_cache_manager.py:246-304)."""
        with self._lock:
            self._maybe_apply_resize_target()
            if self.available_size() < need:
                return None
            out: list[int] = []
            # 1) blocks reserved via try_to_reserve.
            take = min(need, len(self._reserved_blocks))
            if take:
                out.extend(self._reserved_blocks[:take])
                del self._reserved_blocks[:take]
            # 2) partially-used pages, then fresh pages.
            while len(out) < need:
                if self._avail_pages:
                    vp, page = self._avail_pages.popitem(last=False)
                else:
                    page = self.page_allocator.alloc_page()
                    if page is None:
                        # Physical pressure raced available_size; roll back.
                        if out:
                            self.free(out)
                        return None
                    vp = page.vpage
                got = page.alloc(need - len(out))
                out.extend(got)
                if page.full:
                    self._full_pages[vp] = page
                else:
                    self._avail_pages[vp] = page
            return out

    def free(self, block_ids: Sequence[int]) -> None:
        """Free blocks; empty pages go back to the allocator
        (reference kv_cache_manager.py:306-360)."""
        if len(block_ids) == 0:
            return
        with self._lock:
            if SANITY_CHECK:
                reserved = set(self._reserved_blocks)
                assert not (set(block_ids) & reserved), "free of reserved block"
            grouped = group_blocks_by_page(block_ids, self.blocks_per_page)
            empties: list[int] = []
            for vp, ids in grouped.items():
                page = self._avail_pages.get(vp) or self._full_pages.get(vp)
                assert page is not None, f"free of blocks {ids} on unknown page {vp}"
                was_full = page.full
                page.free_batch(ids)
                if was_full:
                    del self._full_pages[vp]
                    self._avail_pages[vp] = page
                if page.empty:
                    self._avail_pages.pop(vp, None)
                    empties.append(vp)
            if empties:
                self.page_allocator.free_pages(empties)
            if self._in_shrink and self._shrink_satisfied():
                self._complete_deferred_shrink()

    # --------------------------------------------------------------- reserve

    def try_to_reserve(self, need: int) -> bool:
        """Pre-claim blocks for a future alloc (reference :362-372)."""
        with self._lock:
            blocks = self.alloc(need)
            if blocks is None:
                return False
            self._reserved_blocks.extend(blocks)
            return True

    def free_reserved(self) -> None:
        with self._lock:
            if self._reserved_blocks:
                blocks = self._reserved_blocks
                self._reserved_blocks = []
                self.free(blocks)

    # ---------------------------------------------------------------- resize

    def resize(self, new_bytes: int) -> bool:
        """Apply an elastic limit (bytes across all layers/buffers).

        Shrinks that can't be honored yet set deferred-shrink mode; frees
        complete it later (reference kv_cache_manager.py:380-401)."""
        with self._lock:
            ok = self.page_allocator.resize(new_bytes)
            if ok:
                self._in_shrink = False
                self._target_num_blocks = None
            else:
                self._in_shrink = True
                self._target_num_blocks = (
                    self.page_allocator.limit_pages * self.blocks_per_page
                )
            return ok

    def _maybe_apply_resize_target(self) -> None:
        target = self.page_allocator.get_resize_target()
        if target is not None:
            logger.info("applying operator resize target: %d bytes", target)
            self.resize(target)

    def _shrink_satisfied(self) -> bool:
        used_blocks = self.page_allocator.num_in_use * self.blocks_per_page
        return (
            self._target_num_blocks is not None
            and used_blocks <= self._target_num_blocks
        )

    def _complete_deferred_shrink(self) -> None:
        self.page_allocator.trim()
        self._in_shrink = False
        self._target_num_blocks = None
        logger.info("deferred shrink completed")

    def trim(self) -> None:
        with self._lock:
            self.page_allocator.trim()

    # ------------------------------------------------------------ accounting

    def available_size(self) -> int:
        """Blocks allocatable right now (reference :411-423): free slots in
        partially-used pages + reserved blocks + obtainable pages × bpp."""
        with self._lock:
            partial = sum(p.num_free for p in self._avail_pages.values())
            pages = self.page_allocator.get_avail_page_slots()
            return partial + len(self._reserved_blocks) + pages * self.blocks_per_page

    def get_mapped_memory_size(self) -> int:
        return self.page_allocator.get_mapped_bytes()

    @property
    def in_shrink(self) -> bool:
        return self._in_shrink

    # ---------------------------------------------------------------- clear

    def clear(self) -> None:
        """Free everything and restore a pristine allocator so the null block
        is block 0 again (reference :443-489)."""
        with self._lock:
            all_blocks: list[int] = []
            for pages in (self._avail_pages, self._full_pages):
                for page in pages.values():
                    all_blocks.extend(page.used_blocks())
            self._reserved_blocks = []
            self.free(all_blocks)
            self.page_allocator.reset()
            if self.null_block is not None:
                blocks = self.alloc(1)
                assert blocks is not None and blocks[0] == 0
                self.null_block = blocks[0]

    def shutdown(self) -> None:
        self.page_allocator.shutdown()
        if self._tracker is not None:
            self._tracker.close()
