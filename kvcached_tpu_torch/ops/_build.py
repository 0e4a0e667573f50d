"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
attention kernels K1, K3 and K4 take the head dim as a compile-time
constant: their sources are compiled once more with ``-DKVC_HEAD_DIM=256``
into libraries of their own (``paged_decode_d256`` and so on), and the
wrappers pick a library by the pools' width (:func:`lib_name`).  The build
happens at first use, all libraries at once (one ``nvcc`` process per
library, started together), into a build directory that git ignores:
``kvcached_tpu_torch/csrc/build`` or ``$KVCACHED_TORCH_BUILD_DIR``.  A
library's file name carries a hash of its source, headers and flags, so an
edited source is rebuilt and an unchanged one is reused.

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
#: head dims of the attention kernels K1, K3 and K4 (csrc KVC_HEAD_DIM)
HEAD_DIMS = (128, 256)
#: sources whose kernels take the head dim as a compile-time constant
PER_HEAD_DIM = ("paged_decode", "paged_prefill", "paged_verify")
#: library name -> (source, extra nvcc flags): every source once, and the
#: per-head-dim ones again for each other width
LIBRARIES = {
    **{n: (n, ()) for n in ("paged_decode", "prefill_write", "paged_prefill",
                            "paged_verify", "mla_attend", "decode_tokens_write")},
    **{f"{n}_d{d}": (n, (f"-DKVC_HEAD_DIM={d}",))
       for n in PER_HEAD_DIM for d in HEAD_DIMS[1:]},
}
HEADERS = ("kv_common.cuh",)
#: no --use_fast_math: it makes the int8 writers' ``x / scale`` an
#: approximate divide, and the pools would no longer be bit-exact with the
#: reference's; and it makes the soft-cap's ``tanhf`` the approximate one,
#: ~0.025 off in a score capped at 50
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types, by source (pointers and the
#: stream as c_void_p, so 64-bit addresses are passed whole; the attention
#: entry points lead with dtype and head_dim)
_SIGNATURES = {
    "paged_decode": {"kvc_paged_decode": [_I, _I] + [_P] * 13 + [_I] * 8 + [_F, _F, _I, _P]},
    "prefill_write": {"kvc_prefill_write": [_P] * 5 + [_I] * 5 + [_P],
                      "kvc_prefill_write_quant": [_I] + [_P] * 7 + [_I] * 5 + [_P],
                      "kvc_prefill_write_single": [_P] * 3 + [_I] * 5 + [_P]},
    "paged_prefill": {"kvc_paged_prefill": [_I, _I] + [_P] * 9 + [_I] * 9 + [_F, _F, _P]},
    "paged_verify": {"kvc_paged_verify": [_I, _I] + [_P] * 13 + [_I] * 9 + [_F, _F, _P]},
    "mla_attend": {"kvc_mla_attend": [_I] + [_P] * 11 + [_I] * 9 + [_F, _P],
                   "kvc_mla_wave_blocks": [_I, _I, ctypes.POINTER(_I)]},
    "decode_tokens_write": {"kvc_decode_tokens_write": [_I, _I] + [_P] * 9 + [_I] * 8 + [_P]},
}


def lib_name(source: str, head_dim: int) -> str:
    """The library of ``source``'s kernels at ``head_dim`` (one of
    :data:`HEAD_DIMS`, which the wrappers check): the source's own name at
    128, ``<source>_d<D>`` otherwise."""
    return source if head_dim == HEAD_DIMS[0] else f"{source}_d{head_dim}"


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
    source, defines = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for f in (source + ".cu",) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict[str, str]:
    """Compile every kernel library that has no up-to-date build, all in
    parallel.  Returns {library name: path}; raises with nvcc's output if
    any build fails.  nvcc's output (with ``ptxas -v``'s registers, spill
    bytes and shared memory per kernel) is kept in ``<name>.log``."""
    with _lock:
        os.makedirs(build_dir(), exist_ok=True)
        paths = {n: _lib_path(n) for n in LIBRARIES}
        todo = [n for n in LIBRARIES if not os.path.exists(paths[n])]
        if todo:
            nvcc = nvcc_path()
            procs = {}
            for n in todo:
                tmp = f"{paths[n]}.{os.getpid()}.tmp"
                source, defines = LIBRARIES[n]
                cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", tmp,
                       os.path.join(CSRC, source + ".cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, p) in procs.items():
                out, _ = p.communicate()
                with open(os.path.join(build_dir(), n + ".log"), "w") as f:
                    f.write(out)
                if p.returncode != 0:
                    failed.append(f"--- {n} (nvcc rc={p.returncode})\n{out}")
                else:
                    os.replace(tmp, paths[n])
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`LIBRARIES`), built on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                for fn_name, argtypes in _SIGNATURES[LIBRARIES[name][0]].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
