"""Engine-side shm tracker (reference: kvcached/mem_info_tracker.py, 102 LoC).

One process-wide cleanup chain (atexit + SIGINT/SIGTERM) so multiple trackers
in one process don't clobber each other's handlers (reference :20-47).
Hybrid-attention groups get a ``_g<id>`` suffix (reference :61).
"""

from __future__ import annotations

import atexit
import os
import signal
import threading

from . import shm
from .logging_utils import get_kvcached_logger

logger = get_kvcached_logger(__name__)

_registry_lock = threading.Lock()
_registry: dict[str, "MemInfoTracker"] = {}
_handlers_installed = False
_prev_handlers: dict[int, object] = {}


def _cleanup_all(*_args) -> None:
    with _registry_lock:
        trackers = list(_registry.values())
    for t in trackers:
        t.close()


def _signal_chain(signum, frame):
    _cleanup_all()
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _install_handlers_once() -> None:
    global _handlers_installed
    if _handlers_installed:
        return
    _handlers_installed = True
    atexit.register(_cleanup_all)
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                _prev_handlers[sig] = signal.getsignal(sig)
                signal.signal(sig, _signal_chain)
            except (ValueError, OSError):
                pass


class MemInfoTracker:
    """Owns one shm segment for the lifetime of an engine instance/group."""

    def __init__(self, ipc_name: str, group_id: int = 0, total_size: int = 0):
        suffix = f"_g{group_id}" if group_id else ""
        self.ipc_name = ipc_name + suffix
        self._closed = False
        shm.init_kv_cache_limit(self.ipc_name, total_size)
        with _registry_lock:
            _registry[self.ipc_name] = self
        _install_handlers_once()

    # -- engine-facing API ---------------------------------------------------

    def update_memory_usage(self, used_size: int, prealloc_size: int) -> None:
        if self._closed:
            return
        shm.update_memory_usage(self.ipc_name, used_size, prealloc_size)

    def check_and_get_resize_target(
        self, num_layers: int, num_kv_buffers: int
    ) -> int | None:
        """Read the operator-imposed limit; return per-layer-per-buffer bytes.

        Mirrors reference mem_info_tracker.hpp:191-204: resize target =
        total / num_layers / num_kv_buffers.  Returns None when the segment
        is missing.
        """
        info = shm.get_kv_cache_info(self.ipc_name)
        if info is None:
            return None
        return info.total_size // max(1, num_layers * num_kv_buffers)

    def get_total_limit(self) -> int | None:
        info = shm.get_kv_cache_info(self.ipc_name)
        return None if info is None else info.total_size

    def set_total_limit(self, total_size: int) -> None:
        shm.update_kv_cache_limit(self.ipc_name, total_size)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with _registry_lock:
            _registry.pop(self.ipc_name, None)
        shm.delete_kv_cache_segment(self.ipc_name)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
