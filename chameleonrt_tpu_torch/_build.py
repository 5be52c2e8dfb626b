"""Builds the port's CUDA kernels at first use, from the repository's sources.

Each kernel source (csrc/*.cu) compiles with its own nvcc, all at once,
for sm_90a; the objects link into one shared library with a plain C
interface, loaded with ctypes. The library goes to
chameleonrt_tpu_torch/_build/, named by a hash of its sources and nvcc's
flags, so an edited source or flag never loads a stale library. A file lock serializes concurrent
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
import time

from chameleonrt_tpu_torch.core import tracing

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# what the traversal kernels hold (kSmallStack, kMaxStack, kMaxLeaf in
# csrc/traverse_common.cuh): every kernel is instantiated at each
# stack capacity; ops/traverse_cuda.py checks the library against the largest
STACK_CAPACITIES = (64, 128)
MAX_STACK = STACK_CAPACITIES[-1]
MAX_LEAF = 16


def _digest(paths, build=()) -> str:
    """Hash of the sources at paths and of what builds them (build: the
    compiler, its version, its flags), so neither an edited source nor a
    changed build loads a stale library."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    for s in build:
        h.update(b"\1" + s.encode())
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


def _compile_all(nvcc: str, cus, obj_dir: str, timeout: int) -> str:
    """One nvcc -c per source, all started together; returns their output
    (ptxas register and spill counts), source by source."""
    procs, logs, failed = [], [], []
    try:
        for cu in cus:
            obj = os.path.join(obj_dir, os.path.basename(cu)[: -len(".cu")] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        deadline = time.monotonic() + timeout
        for cmd, proc in procs:
            try:
                out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(logs[-1])
    finally:
        for _, proc in procs:  # none outlives a failure above
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def kernel_library_path() -> str:
    """Path of the kernels' library (B1-B7b, S1 and R1-R3), compiled if missing. nvcc's
    output (ptxas register and spill counts) is kept beside it, with the
    extension .log."""
    sources = sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )
    out = os.path.join(BUILD_DIR, f"libcrt_kernels_{_digest(sources, NVCC_FLAGS)}.so")
    with _file_lock("kernels"):
        if not os.path.exists(out):
            tracing.count("kernel_builds")
            nvcc = find_nvcc()
            obj_dir = out[: -len(".so")] + f".obj{os.getpid()}"
            os.makedirs(obj_dir, exist_ok=True)
            try:
                cus = [s for s in sources if s.endswith(".cu")]
                log = _compile_all(nvcc, cus, obj_dir, 900)
                objs = [os.path.join(obj_dir, os.path.basename(c)[: -len(".cu")] + ".o") for c in cus]
                tmp = out + f".tmp{os.getpid()}"
                log += _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                             "-o", tmp, *objs], 300)
                with open(out[: -len(".so")] + ".log", "w") as f:
                    f.write(log)
                os.replace(tmp, out)
            finally:
                shutil.rmtree(obj_dir, ignore_errors=True)
    return out


def load_library(path: str) -> ctypes.CDLL:
    """The kernels' library at path, loaded. Each wrapper module binds its
    own entries' C signatures at first use (ops/traverse_cuda.py,
    ops/shade_cuda.py, ops/sort_cuda.py); here only the error string that
    every launch failure reads."""
    lib = ctypes.CDLL(path)
    lib.crt_error_string.argtypes = [ctypes.c_int]
    lib.crt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The kernels' library (B1-B7b, S1 and R1-R3), compiled and loaded on first
    call (load_library)."""
    with tracing.span("kernels.load"):
        return load_library(kernel_library_path())
