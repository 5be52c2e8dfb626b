"""Builds the port's CUDA kernels at first use, from the repository's sources.

The kernels (csrc/*.cu) compile with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. The library goes to
chameleonrt_tpu_torch/_build/, named by a hash of its sources, so an edited
source never loads a stale library. A file lock serializes concurrent
builds (test workers, for one).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _file_lock(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, name + ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _run(cmd, timeout: int) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"build failed ({' '.join(cmd)}):\n{out}")
    return out


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")
    return nvcc


def kernel_library_path() -> str:
    """Path of the traversal kernels' library, compiled if missing. nvcc's
    output (ptxas register and spill counts) is kept beside it, with the
    extension .log."""
    sources = sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )
    out = os.path.join(BUILD_DIR, f"libcrt_kernels_{_digest(sources)}.so")
    with _file_lock("kernels"):
        if not os.path.exists(out):
            tmp = out + f".tmp{os.getpid()}"
            cus = [s for s in sources if s.endswith(".cu")]
            log = _run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus], 900)
            with open(out[: -len(".so")] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The traversal kernels' library, compiled and loaded on first call."""
    lib = ctypes.CDLL(kernel_library_path())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crt_traverse_closest.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p, p, p, i, p]
    lib.crt_traverse_closest.restype = i
    lib.crt_traverse_any.argtypes = [p, p, i, i, i, p, p, p, p, p, p, i, p]
    lib.crt_traverse_any.restype = i
    lib.crt_error_string.argtypes = [i]
    lib.crt_error_string.restype = ctypes.c_char_p
    lib.crt_max_stack.argtypes = []
    lib.crt_max_stack.restype = i
    lib.crt_max_leaf.argtypes = []
    lib.crt_max_leaf.restype = i
    return lib

