"""Prefix cache: content-addressed KV page reuse with an LRU evictable pool.

Native implementation of the reference's ElasticBlockPool prefix cache
(vllm/patches.py:260-614): pages are keyed by a rolling hash over their
token content chained through the prefix (plus the model/group id — the
composite-key lesson of ``_make_cache_key``), live pages are ref-counted
and shared across sequences, and pages whose refcount drops to zero are
*retained* in an LRU evictable pool bounded by ``MAX_CACHED_TOKENS``
(reference knob) instead of being freed — the elastic pool can reclaim them
on demand, so cached KV costs nothing under pressure.

Because a full page's tokens are immutable, a shared page's KV never
changes; reuse is sound at page granularity.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

from ..config import MAX_CACHED_TOKENS
from ..logging_utils import get_kvcached_logger

logger = get_kvcached_logger(__name__)


def page_keys(tokens: list[int], page_tokens: int, namespace: str = "") -> list[bytes]:
    """Chained content keys for each FULL page of ``tokens``.

    key_j = H(namespace, key_{j-1}, tokens[j*P:(j+1)*P]) — chaining makes a
    page's key depend on its whole prefix, so equal keys ⇒ equal prefix.
    The namespace isolates models/groups sharing one physical pool
    (reference ``_make_cache_key`` hash+group composite, vllm/patches.py:260-274).
    """
    n_full = len(tokens) // page_tokens
    keys = []
    prev = namespace.encode()
    for j in range(n_full):
        chunk = tokens[j * page_tokens : (j + 1) * page_tokens]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(b",".join(str(t).encode() for t in chunk))
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclass
class _Entry:
    block: int
    refcount: int = 0  # sequences currently using this page


class PrefixCache:
    """Tracks content-key → page mappings, refcounts, and the evictable LRU.

    The engine owns actual page allocation; this class only does accounting:

    - ``lookup(keys)`` → longest cached prefix of pages (refcount++ each).
    - ``insert(keys, blocks)`` registers freshly computed full pages.
    - ``release(blocks)`` → pages with refcount 0 move to the evictable LRU;
      returns pages that must be truly freed (cap overflow).
    - ``evict(n)`` → reclaim n pages from the LRU for the allocator.
    """

    def __init__(self, page_tokens: int, max_cached_tokens: int | None = None):
        if max_cached_tokens is None:
            max_cached_tokens = MAX_CACHED_TOKENS
        self.page_tokens = page_tokens
        self.enabled = max_cached_tokens != 0
        self.max_cached_pages = (
            (max_cached_tokens // page_tokens) if max_cached_tokens > 0 else None
        )
        self._by_key: dict[bytes, _Entry] = {}
        self._by_block: dict[int, bytes] = {}
        # blocks with refcount 0, retained; ordered oldest-first
        self._evictable: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ query

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest cached page-prefix; bumps refcounts and reactivates
        evictable pages (the reference's 'touch')."""
        if not self.enabled:
            return []
        out: list[int] = []
        for key in keys:
            e = self._by_key.get(key)
            if e is None:
                break
            e.refcount += 1
            self._evictable.pop(e.block, None)
            out.append(e.block)
        self.hits += len(out)
        self.misses += len(keys) - len(out)
        return out

    # ---------------------------------------------------------------- insert

    def insert(self, keys: list[bytes], blocks: list[int]) -> None:
        """Register computed full pages under their keys; the caller holds
        one reference for the owning sequence."""
        if not self.enabled:
            return
        for key, block in zip(keys, blocks):
            e = self._by_key.get(key)
            if e is not None:
                # another sequence raced the same content; keep the existing
                # entry — caller keeps its private page unshared
                continue
            old_key = self._by_block.get(block)
            if old_key is not None:
                # page was reallocated by the engine after a true free that
                # we weren't told about — drop the stale key
                self._drop_block(block)
            self._by_key[key] = _Entry(block, refcount=1)
            self._by_block[block] = key

    # --------------------------------------------------------------- release

    def release(self, blocks: list[int]) -> tuple[list[int], list[int]]:
        """Sequence finished/preempted: decref its cached pages.

        Returns (retained, to_free): ``to_free`` are pages this cache never
        tracked (the caller frees them normally) plus LRU overflow evictions.
        """
        retained: list[int] = []
        to_free: list[int] = []
        for b in blocks:
            key = self._by_block.get(b)
            if key is None:
                to_free.append(b)
                continue
            e = self._by_key[key]
            e.refcount -= 1
            if e.refcount <= 0:
                self._evictable[b] = None
                self._evictable.move_to_end(b)
            retained.append(b)
        # enforce the MAX_CACHED_TOKENS bound
        if self.max_cached_pages is not None:
            while len(self._evictable) > self.max_cached_pages:
                victim, _ = self._evictable.popitem(last=False)
                self._drop_block(victim)
                to_free.append(victim)
                if victim in retained:
                    retained.remove(victim)
        return retained, to_free

    # ----------------------------------------------------------------- evict

    def evict(self, n: int) -> list[int]:
        """Reclaim up to n LRU pages (memory pressure): caller frees them."""
        out = []
        while n > 0 and self._evictable:
            victim, _ = self._evictable.popitem(last=False)
            self._drop_block(victim)
            out.append(victim)
            n -= 1
        return out

    def reset(self) -> list[int]:
        """Drop the whole cache; returns evictable pages to free.  Pages
        still referenced by running sequences just lose their keys."""
        evictable = list(self._evictable.keys())
        self._by_key.clear()
        self._by_block.clear()
        self._evictable.clear()
        return evictable

    # ------------------------------------------------------------- internals

    def _drop_block(self, block: int) -> None:
        key = self._by_block.pop(block, None)
        if key is not None:
            self._by_key.pop(key, None)
        self._evictable.pop(block, None)

    # --------------------------------------------------------------- metrics

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    @property
    def num_tracked(self) -> int:
        return len(self._by_key)

    def get_usage(self) -> dict:
        total = self.hits + self.misses
        return {
            "tracked_pages": self.num_tracked,
            "evictable_pages": self.num_evictable,
            "hit_rate": self.hits / total if total else 0.0,
            "hits": self.hits,
            "misses": self.misses,
        }
