"""Cross-process control plane: /dev/shm segments + flock.

The TPU build keeps the reference's control-plane design unchanged — it is
device-independent (reference ``kvcached/cli/utils.py:28-153``,
``csrc/inc/mem_info_tracker.hpp:39-149``): each engine instance exposes one
small shm file holding ``{total, used, prealloc}`` int64s guarded by
``flock``.  The CLI (`kvctl`/`kvtop`) and the controller write ``total``
(the memory limit); the engine's resize watcher polls it and the allocator
writes ``used``/``prealloc`` on every transition.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import struct
from contextlib import contextmanager
from dataclasses import dataclass

from .config import SHM_DIR

_FMT = "<qqq"  # total_size, used_size, prealloc_size (bytes)
SHM_SIZE = struct.calcsize(_FMT)  # 24


@dataclass
class MemInfo:
    total_size: int = 0
    used_size: int = 0
    prealloc_size: int = 0

    def pack(self) -> bytes:
        return struct.pack(_FMT, self.total_size, self.used_size, self.prealloc_size)

    @classmethod
    def unpack(cls, buf: bytes) -> "MemInfo":
        return cls(*struct.unpack(_FMT, buf[:SHM_SIZE]))


def shm_path(ipc_name: str) -> str:
    return os.path.join(SHM_DIR, ipc_name)


class RwLockedShm:
    """RAII flock + mmap over a /dev/shm file (reference cli/utils.py:54-96).

    Write-lock mode creates the file if missing; read-lock mode raises
    ``FileNotFoundError`` so callers can distinguish "no engine running".
    """

    RLOCK = fcntl.LOCK_SH
    WLOCK = fcntl.LOCK_EX

    def __init__(self, ipc_name: str, mode: int):
        self._path = shm_path(ipc_name)
        self._mode = mode
        self._fd: int | None = None
        self._mm: mmap.mmap | None = None

    def __enter__(self) -> mmap.mmap:
        if self._mode == self.WLOCK:
            self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o666)
            if os.fstat(self._fd).st_size < SHM_SIZE:
                os.ftruncate(self._fd, SHM_SIZE)
        else:
            self._fd = os.open(self._path, os.O_RDONLY)
        fcntl.flock(self._fd, self._mode)
        prot = mmap.PROT_READ | (mmap.PROT_WRITE if self._mode == self.WLOCK else 0)
        self._mm = mmap.mmap(self._fd, SHM_SIZE, prot=prot)
        return self._mm

    def __exit__(self, *exc):
        if self._mm is not None:
            if self._mode == self.WLOCK:
                self._mm.flush()
            self._mm.close()
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
        return None


def init_kv_cache_limit(ipc_name: str, total_size: int) -> None:
    """Create/overwrite the segment with a fresh limit and zero usage."""
    with RwLockedShm(ipc_name, RwLockedShm.WLOCK) as mm:
        mm[:SHM_SIZE] = MemInfo(total_size, 0, 0).pack()


def get_kv_cache_info(ipc_name: str) -> MemInfo | None:
    try:
        with RwLockedShm(ipc_name, RwLockedShm.RLOCK) as mm:
            return MemInfo.unpack(mm[:SHM_SIZE])
    except FileNotFoundError:
        return None


def update_kv_cache_limit(ipc_name: str, total_size: int) -> MemInfo:
    """Operator-facing limit update (kvctl limit). Preserves usage fields."""
    with RwLockedShm(ipc_name, RwLockedShm.WLOCK) as mm:
        info = MemInfo.unpack(mm[:SHM_SIZE])
        info.total_size = total_size
        mm[:SHM_SIZE] = info.pack()
        return info


def update_memory_usage(ipc_name: str, used_size: int, prealloc_size: int) -> None:
    """Engine-side usage report (called on every alloc/free/trim transition)."""
    with RwLockedShm(ipc_name, RwLockedShm.WLOCK) as mm:
        info = MemInfo.unpack(mm[:SHM_SIZE])
        info.used_size = used_size
        info.prealloc_size = prealloc_size
        mm[:SHM_SIZE] = info.pack()


def delete_kv_cache_segment(ipc_name: str) -> bool:
    try:
        os.unlink(shm_path(ipc_name))
        return True
    except FileNotFoundError:
        return False


def list_segments() -> list[str]:
    """Auto-detect kvcached segments by exact file size (reference kvtop.py:13-38)."""
    out = []
    try:
        for name in os.listdir(SHM_DIR):
            p = os.path.join(SHM_DIR, name)
            try:
                if os.path.isfile(p) and os.path.getsize(p) == SHM_SIZE and name.startswith("kvcached"):
                    out.append(name)
            except OSError:
                continue
    except FileNotFoundError:
        pass
    return sorted(out)


@contextmanager
def temporary_segment(ipc_name: str, total_size: int):
    init_kv_cache_limit(ipc_name, total_size)
    try:
        yield ipc_name
    finally:
        delete_kv_cache_segment(ipc_name)
