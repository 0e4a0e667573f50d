"""Allocator core: page bookkeeping, prealloc + resize-watcher threads.

A copy of the pure-Python core of ``kvcached_tpu.core``.  Binding the C++
core (``csrc/`` of the JAX package) is later work; until then
``get_page_allocator_cls()`` always returns the Python allocator.
"""

from __future__ import annotations

from .page_allocator_py import (
    HostPagePool,
    PageAllocator,
    PageState,
    group_blocks_by_page,
)

__all__ = [
    "PageAllocator",
    "PageState",
    "HostPagePool",
    "group_blocks_by_page",
    "get_page_allocator_cls",
]


def get_page_allocator_cls():
    return PageAllocator
