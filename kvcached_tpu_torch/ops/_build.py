"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, all sources at once (one ``nvcc`` process per
source, started together), into a build directory that git ignores:
``kvcached_tpu_torch/csrc/build`` or ``$KVCACHED_TORCH_BUILD_DIR``.  A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing here runs at import time; the CPU path never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = ("paged_decode", "prefill_write", "paged_prefill", "paged_verify")
HEADERS = ("kv_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point and argument types of each library (pointers and the
#: stream as c_void_p, so 64-bit addresses are passed whole)
_SIGNATURES = {
    "paged_decode": ("kvc_paged_decode", [_I] + [_P] * 11 + [_I] * 8 + [_F, _I, _P]),
    "prefill_write": ("kvc_prefill_write", [_P] * 5 + [_I] * 5 + [_P]),
    "paged_prefill": ("kvc_paged_prefill", [_I] + [_P] * 7 + [_I] * 9 + [_F, _P]),
    "paged_verify": ("kvc_paged_verify", [_I] + [_P] * 11 + [_I] * 9 + [_F, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("KVCACHED_TORCH_BUILD_DIR") or os.path.join(CSRC, "build")


def nvcc_path() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (name + ".cu",) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no up-to-date library, all in
    parallel.  Returns {source name: library path}; raises with nvcc's
    output if any build fails.  nvcc's output (with ``ptxas -v``'s
    registers and shared memory per kernel) is kept in ``<name>.log``."""
    with _lock:
        os.makedirs(build_dir(), exist_ok=True)
        paths = {n: _lib_path(n) for n in SOURCES}
        todo = [n for n in SOURCES if not os.path.exists(paths[n])]
        if todo:
            nvcc = nvcc_path()
            procs = {}
            for n in todo:
                tmp = f"{paths[n]}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, p) in procs.items():
                out, _ = p.communicate()
                with open(os.path.join(build_dir(), n + ".log"), "w") as f:
                    f.write(out)
                if p.returncode != 0:
                    failed.append(f"--- {n}.cu (nvcc rc={p.returncode})\n{out}")
                else:
                    os.replace(tmp, paths[n])
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                fn_name, argtypes = _SIGNATURES[name]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
