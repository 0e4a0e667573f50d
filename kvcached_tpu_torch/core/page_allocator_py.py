"""Pure-Python allocator core.

TPU translation of the reference's C++ L1–L3 stack (``csrc/page.cpp``,
``csrc/page_allocator.cpp``).  On TPU there is no user-visible virtual-memory
remapping, so the reference's central trick — one virtual tensor whose pages
are rebacked by ``cuMemMap`` at runtime — becomes **page-table indirection**:

- A *physical page pool* is a preallocated arena (HBM pool tensor on device,
  or host memory in tests) of ``capacity`` fixed-size pages.  Physical page 0
  is the **zero page**: every unmapped virtual page's table entry points at
  it, so reads of unallocated blocks are defined (the reference's zero-page
  aliasing semantics, csrc/ftensor.cpp:160-176).
- Each engine instance/group owns a *virtual page space* sized to
  total-HBM-worth (the analogue of the 8 GB VA reservation).  "map" assigns a
  physical page to a virtual page and records it in an int32 page table —
  pure metadata, ~100 ns vs ~200 µs for cuMemCreate+cuMemMap.  "unmap"
  returns the physical page and points the entry back at the zero page.

Because mapping is cheap, the reference's careful off-critical-path machinery
(reserved pre-mapped pages maintained by a prealloc thread,
csrc/page_allocator.cpp:536-617) matters on TPU mainly when map/unmap has a
*broadcast* cost (multi-host page-table mirrors) — we keep the same
structure so that cost also stays off the decode path.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Protocol, Sequence

import numpy as np

from ..config import (
    MAX_RESERVED_PAGES,
    MIN_RESERVED_PAGES,
    PAGE_PREALLOC_ENABLED,
    RESIZE_POLL_MS,
    SANITY_CHECK,
)
from ..logging_utils import get_kvcached_logger

logger = get_kvcached_logger(__name__)

ZERO_PAGE = 0  # physical page id reserved as the shared zero page


class PhysicalBackend(Protocol):
    """Source of physical pages (the ``GPUPage``/``CPUPage`` role)."""

    def acquire(self, n: int) -> list[int] | None: ...
    def release(self, page_ids: Sequence[int]) -> None: ...
    def avail_physical_pages(self) -> int: ...
    @property
    def capacity(self) -> int: ...


class HostPagePool:
    """Host-memory physical pool for tests and CPU simulation (``CPUPage``).

    Page 0 is the zero page and is never handed out.
    """

    def __init__(self, capacity: int):
        assert capacity >= 1
        self._capacity = capacity
        self._free: deque[int] = deque(range(1, capacity))
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    def acquire(self, n: int) -> list[int] | None:
        with self._lock:
            if len(self._free) < n:
                return None
            return [self._free.popleft() for _ in range(n)]

    def release(self, page_ids: Sequence[int]) -> None:
        with self._lock:
            for p in page_ids:
                assert p != ZERO_PAGE, "cannot release the zero page"
                self._free.append(p)

    def avail_physical_pages(self) -> int:
        with self._lock:
            return len(self._free)


class PageState:
    """Block bookkeeping within one mapped page (reference ``InternalPage``,
    csrc/page_allocator.cpp:40-100).

    Block ids are global: page ``vp`` holds blocks
    ``[vp * blocks_per_page, (vp+1) * blocks_per_page)``.  Page geometry is
    validated so blocks never straddle pages (config.validate_page_geometry),
    which removes the reference's straddle-skip logic entirely.
    """

    __slots__ = ("vpage", "blocks_per_page", "_free")

    def __init__(self, vpage: int, blocks_per_page: int):
        self.vpage = vpage
        self.blocks_per_page = blocks_per_page
        base = vpage * blocks_per_page
        self._free = list(range(base + blocks_per_page - 1, base - 1, -1))

    def alloc(self, n: int = 1) -> list[int]:
        n = min(n, len(self._free))
        out = self._free[-n:][::-1] if n else []
        del self._free[len(self._free) - n :]
        return out

    def free_batch(self, block_ids: Sequence[int]) -> None:
        if SANITY_CHECK:
            base = self.vpage * self.blocks_per_page
            for b in block_ids:
                assert base <= b < base + self.blocks_per_page, (
                    f"block {b} not in page {self.vpage}"
                )
                assert b not in self._free, f"double free of block {b}"
        self._free.extend(block_ids)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def used_blocks(self) -> list[int]:
        base = self.vpage * self.blocks_per_page
        free = set(self._free)
        return [b for b in range(base, base + self.blocks_per_page) if b not in free]

    @property
    def empty(self) -> bool:
        return len(self._free) == self.blocks_per_page

    @property
    def full(self) -> bool:
        return not self._free


def group_blocks_by_page(
    block_ids: Sequence[int], blocks_per_page: int
) -> dict[int, list[int]]:
    """Group block ids by their virtual page (reference
    ``group_indices_by_page``, csrc/page_allocator.cpp:471-498 — a measured
    3× hot-path win in C++; the native core mirrors this in C++)."""
    out: dict[int, list[int]] = {}
    for b in block_ids:
        out.setdefault(b // blocks_per_page, []).append(b)
    return out


MapHook = Callable[[list[int], list[int]], None]  # (vpages, ppages)


class PageAllocator:
    """Virtual-page allocator for one group (reference ``PageAllocator``,
    csrc/page_allocator.cpp:102-783).

    State machine per virtual page:

        FREE --map--> RESERVED (mapped, 0 blocks used) --> IN_USE
          ^                |                                |
          |             (trim/unmap)                     (free)
          +----------------+--------- RECLAIMED (shrink) ---+

    - ``free``: unmapped vpages inside the current limit.
    - ``reserved``: mapped, blockless pages kept warm by the prealloc thread
      so ``alloc_page`` never maps on the critical path.
    - ``reclaimed``: vpages surrendered by a shrink; reused first on grow.
    - mapped+in-use pages live with the caller (KVCacheManager) as PageState.
    """

    def __init__(
        self,
        *,
        virtual_pages: int,
        blocks_per_page: int,
        page_bytes: int,
        backend: PhysicalBackend,
        page_table: np.ndarray | None = None,
        map_hook: MapHook | None = None,
        unmap_hook: MapHook | None = None,
        mem_info_tracker=None,
        num_layers: int = 1,
        num_kv_buffers: int = 2,
        enable_prealloc: bool = PAGE_PREALLOC_ENABLED,
        min_reserved: int = MIN_RESERVED_PAGES,
        max_reserved: int = MAX_RESERVED_PAGES,
    ):
        assert virtual_pages > 0
        self.virtual_pages = virtual_pages
        self.blocks_per_page = blocks_per_page
        self.page_bytes = page_bytes
        self.backend = backend
        self.num_layers = num_layers
        self.num_kv_buffers = num_kv_buffers
        self.min_reserved = min_reserved
        self.max_reserved = max_reserved

        # int32 virtual→physical page table; entry ZERO_PAGE == unmapped.
        if page_table is None:
            page_table = np.full(virtual_pages, ZERO_PAGE, dtype=np.int32)
        assert page_table.shape[0] >= virtual_pages
        self.page_table = page_table

        self._map_hook = map_hook
        self._unmap_hook = unmap_hook
        self._tracker = mem_info_tracker

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._free: deque[int] = deque(range(virtual_pages))
        self._reserved: deque[int] = deque()
        self._reclaimed: deque[int] = deque()
        self._num_mapped = 0  # reserved + in-use
        self._in_use = 0  # mapped pages handed to the caller
        self._peak_in_use = 0  # high-water mark
        # Current limit in pages (elastic). Starts at the full virtual space.
        self._limit_pages = virtual_pages

        self._resize_target = threading.Event()
        self._resize_target_bytes: int | None = None

        self._stop = threading.Event()
        self._prealloc_thread: threading.Thread | None = None
        self._watcher_thread: threading.Thread | None = None
        if enable_prealloc:
            self.start_prealloc_thread()
        if mem_info_tracker is not None:
            self._start_resize_watcher()
        self._update_shm()

    # ------------------------------------------------------------------ util

    def _update_shm(self) -> None:
        if self._tracker is None:
            return
        used = self._in_use * self.page_bytes
        prealloc = len(self._reserved) * self.page_bytes
        try:
            self._tracker.update_memory_usage(used, prealloc)
        except Exception as e:  # shm gone during teardown
            logger.debug("shm usage update failed: %s", e)

    def _map_pages_locked(self, vpages: list[int]) -> bool:
        """Attach physical pages (metadata only). Returns False on pressure."""
        ppages = self.backend.acquire(len(vpages))
        if ppages is None:
            return False
        for vp, pp in zip(vpages, ppages):
            self.page_table[vp] = pp
        self._num_mapped += len(vpages)
        if self._map_hook is not None:
            self._map_hook(vpages, ppages)
        return True

    def _unmap_pages_locked(self, vpages: list[int]) -> None:
        ppages = [int(self.page_table[vp]) for vp in vpages]
        if SANITY_CHECK:
            assert all(p != ZERO_PAGE for p in ppages), "unmap of unmapped page"
        for vp in vpages:
            self.page_table[vp] = ZERO_PAGE
        self._num_mapped -= len(vpages)
        if self._unmap_hook is not None:
            self._unmap_hook(vpages, ppages)
        self.backend.release(ppages)

    # ------------------------------------------------------------- alloc/free

    def alloc_page(self) -> PageState | None:
        """Hand one mapped page to the caller (reference
        page_allocator.cpp:161-237).  Fast path: pop a pre-mapped reserved
        page and nudge the prealloc thread; slow path: map a free page inline.
        """
        with self._lock:
            if self._in_use >= self._limit_pages:
                return None
            vp: int | None = None
            if self._reserved:
                vp = self._reserved.popleft()
                self._cond.notify_all()  # wake prealloc to refill
            elif self._free:
                if self.backend.avail_physical_pages() < 1:
                    return None
                vp = self._free.popleft()
                if not self._map_pages_locked([vp]):
                    self._free.appendleft(vp)
                    return None
            else:
                return None
            self._in_use += 1
            self._peak_in_use = max(self._peak_in_use, self._in_use)
            self._update_shm()
            return PageState(vp, self.blocks_per_page)

    def free_pages(self, vpages: Sequence[int]) -> None:
        """Return empty pages (reference page_allocator.cpp:264-310): refill
        the reserved pool up to ``max_reserved`` (stay mapped), unmap the rest.
        """
        if not vpages:
            return
        with self._lock:
            to_unmap: list[int] = []
            for vp in vpages:
                self._in_use -= 1
                if len(self._reserved) < self.max_reserved:
                    self._reserved.append(vp)
                else:
                    to_unmap.append(vp)
            if to_unmap:
                self._unmap_pages_locked(to_unmap)
                self._free.extend(to_unmap)
            self._update_shm()

    def trim(self) -> None:
        """Unmap the whole reserved pool (reference page_allocator.cpp:403-427)."""
        with self._lock:
            if self._reserved:
                pages = list(self._reserved)
                self._reserved.clear()
                self._unmap_pages_locked(pages)
                self._free.extend(pages)
            self._update_shm()

    # ---------------------------------------------------------------- resize

    def resize(self, new_bytes: int) -> bool:
        """Elastic limit change (reference page_allocator.cpp:312-401).

        Grow: restore reclaimed vpages to the free list first.
        Shrink: reclaim free vpages, then trim reserved; if in-use still
        exceeds the target, shrink what we can and report False so the
        caller (KVCacheManager) enters deferred-shrink mode.
        Returns True when the limit was fully honored.
        """
        new_limit = min(self.virtual_pages, max(0, new_bytes // self.page_bytes))
        with self._lock:
            cur = self._limit_pages
            if new_limit == cur:
                return True
            if new_limit > cur:
                # Grow: bring reclaimed pages back.
                need = new_limit - cur
                restore = [self._reclaimed.popleft() for _ in range(min(need, len(self._reclaimed)))]
                self._free.extend(restore)
                self._limit_pages = new_limit
                self._update_shm()
                return True
            # Shrink.
            shrink = cur - new_limit
            # 1) reclaim unmapped free pages (no cost).
            take = min(shrink, len(self._free))
            for _ in range(take):
                self._reclaimed.append(self._free.pop())
            shrink -= take
            # 2) trim reserved (unmap, then reclaim).
            if shrink > 0 and self._reserved:
                take = min(shrink, len(self._reserved))
                pages = [self._reserved.pop() for _ in range(take)]
                self._unmap_pages_locked(pages)
                self._reclaimed.extend(pages)
                shrink -= take
            self._limit_pages = new_limit
            self._update_shm()
            # 3) in-use pages can't be revoked — caller defers.
            return shrink == 0

    # ------------------------------------------------------------ accounting

    @property
    def limit_pages(self) -> int:
        return self._limit_pages

    @property
    def num_in_use(self) -> int:
        return self._in_use

    @property
    def peak_in_use(self) -> int:
        """High-water in_use mark (exact; survives frees/preemptions)."""
        return self._peak_in_use

    def reset_peak_in_use(self) -> None:
        self._peak_in_use = self._in_use

    @property
    def num_reserved(self) -> int:
        return len(self._reserved)

    @property
    def num_free_virtual(self) -> int:
        return len(self._free)

    def get_avail_page_slots(self) -> int:
        """Pages this group could still obtain right now: bounded by both the
        virtual limit and physical availability (incl. already-reserved pages,
        which are mapped and instantly usable).  The analogue of the
        reference's headroom formula (page_allocator.cpp:442-455 +
        kv_cache_manager.py:411-423)."""
        with self._lock:
            virt = max(0, self._limit_pages - self._in_use)
            phys = self.backend.avail_physical_pages() + len(self._reserved)
            return min(virt, phys)

    def get_mapped_bytes(self) -> int:
        with self._lock:
            return self._num_mapped * self.page_bytes

    # ------------------------------------------------------------- prealloc

    def start_prealloc_thread(self) -> None:
        if self._prealloc_thread is not None:
            return
        self._prealloc_thread = threading.Thread(
            target=self._prealloc_loop, name="kvcached-prealloc", daemon=True
        )
        self._prealloc_thread.start()

    def _prealloc_loop(self) -> None:
        """Keep ``min_reserved``–``max_reserved`` pages pre-mapped (reference
        page_allocator.cpp:536-617).  Map failures roll pages back to the
        free list."""
        while not self._stop.is_set():
            with self._cond:
                while (
                    not self._stop.is_set()
                    and (
                        len(self._reserved) >= self.min_reserved
                        or not self._free
                        or self._in_use + len(self._reserved) >= self._limit_pages
                        or self.backend.avail_physical_pages() < 1
                    )
                ):
                    self._cond.wait(timeout=0.05)
                if self._stop.is_set():
                    return
                want = min(
                    self.max_reserved - len(self._reserved),
                    len(self._free),
                    max(0, self._limit_pages - self._in_use - len(self._reserved)),
                    self.backend.avail_physical_pages(),
                )
                if want <= 0:
                    continue
                vpages = [self._free.popleft() for _ in range(want)]
                if self._map_pages_locked(vpages):
                    self._reserved.extend(vpages)
                else:
                    self._free.extendleft(reversed(vpages))
                self._update_shm()

    def stop_prealloc_thread(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in (self._prealloc_thread, self._watcher_thread):
            if t is not None:
                t.join(timeout=2.0)
        self._prealloc_thread = None
        self._watcher_thread = None

    # --------------------------------------------------------- resize watcher

    def _start_resize_watcher(self) -> None:
        # Seed with the current limit so the watcher only reacts to *changes*
        # (otherwise it would re-apply the boot-time total once at startup).
        # Read here, in the constructing thread, so that a limit written
        # after the constructor returns is always a change, however late the
        # watcher thread first runs.
        try:
            last: int | None = self._tracker.get_total_limit()
        except Exception:
            last = None
        self._watcher_thread = threading.Thread(
            target=self._watch_resize, args=(last,),
            name="kvcached-resize-watcher", daemon=True,
        )
        self._watcher_thread.start()

    def _watch_resize(self, last: int | None) -> None:
        """Poll the shm limit every RESIZE_POLL_MS into an atomic target the
        next ``alloc`` picks up (reference page_allocator.cpp:764-782)."""
        while not self._stop.wait(RESIZE_POLL_MS / 1000.0):
            try:
                total = self._tracker.get_total_limit()
            except Exception:
                continue
            if total is None or total <= 0:
                continue
            if total != last:
                last = total
                self._resize_target_bytes = total
                self._resize_target.set()

    def get_resize_target(self) -> int | None:
        """Atomic read of a pending operator-imposed limit (bytes); clears it."""
        if self._resize_target.is_set():
            self._resize_target.clear()
            return self._resize_target_bytes
        return None

    def reset(self) -> None:
        """Unmap all reserved pages and sort the free list ascending so the
        next ``alloc_page`` hands out vpage 0 again (the reference re-sorts
        the free list in ``clear`` so the null block is block 0,
        kv_cache_manager.py:443-489)."""
        with self._lock:
            if self._reserved:
                pages = list(self._reserved)
                self._reserved.clear()
                self._unmap_pages_locked(pages)
                self._free.extend(pages)
            self._free = deque(sorted(self._free))
            self._reclaimed = deque(sorted(self._reclaimed))
            self._update_shm()

    # ---------------------------------------------------------------- close

    def shutdown(self) -> None:
        self.stop_prealloc_thread()
        with self._lock:
            if self._reserved:
                pages = list(self._reserved)
                self._reserved.clear()
                self._unmap_pages_locked(pages)
                self._free.extend(pages)
