"""Lock protocols + no-op implementations (reference: kvcached/locks.py:51-97).

When the engine scheduler is synchronous, the KV manager runs on one thread
and locking is pure overhead; ``NoOpLock``/``NoOpCondition`` keep the code
shape identical while compiling to nothing.
"""

from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable


@runtime_checkable
class LockLike(Protocol):
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool: ...
    def release(self) -> None: ...
    def __enter__(self): ...
    def __exit__(self, *exc) -> bool | None: ...


class NoOpLock:
    """Context-manager lock that does nothing (single-threaded fast path)."""

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return True

    def release(self) -> None:
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


class NoOpCondition:
    def __init__(self, lock=None):
        self._lock = lock or NoOpLock()

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        return True

    def notify(self, n: int = 1) -> None:
        return None

    def notify_all(self) -> None:
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def make_lock(async_sched: bool) -> LockLike:
    """RLock iff the scheduler is asynchronous, else a no-op lock
    (reference: kv_cache_manager.py:180-181)."""
    return threading.RLock() if async_sched else NoOpLock()
