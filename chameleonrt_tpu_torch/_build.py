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
# stack capacity; kernels() checks the library against the largest
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
    """The kernels' library at path (B1-B7b, S1 and R1-R3), loaded and bound. Every
    entry of B1-B6d takes the node rows' arity (2, 4 or 8) before the leaf
    size, and every entry the stack capacity after the depth; B7a/B7b take
    binary rows only."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    # B1 / B5a: nodes, leaf rows, leaves, arity, L, depth, capacity, rays..., R, stream
    flat_closest = [p, p, i, i, i, i, i, p, p, p, p, p, p, p, p, p, i, p]
    lib.crt_traverse_closest.argtypes = flat_closest
    lib.crt_traverse_closest_stream.argtypes = flat_closest
    # B2 / B5b: nodes, leaf rows, leaves, arity, L, depth, capacity, rays..., R, stream
    flat_any = [p, p, i, i, i, i, i, p, p, p, p, p, p, i, p]
    lib.crt_traverse_any.argtypes = flat_any
    lib.crt_traverse_any_stream.argtypes = flat_any
    # B3 / B4, B5c / B5d: nodes, leaf rows, n_tri, tlas_lo, arity, L, depth, capacity, rays...,
    # R, stream
    unified_closest = [p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, i, p]
    unified_any = [p, p, i, i, i, i, i, i, p, p, p, p, p, p, i, p]
    for tier in ("_unified", "_unified_stream"):
        getattr(lib, f"crt_traverse_closest{tier}").argtypes = unified_closest
        getattr(lib, f"crt_traverse_any{tier}").argtypes = unified_any
    # the work-queue kernels take one more pointer, the queue's counter, before R
    for kind in ("closest", "any"):
        for tier in ("", "_unified"):
            base = getattr(lib, f"crt_traverse_{kind}{tier}").argtypes
            getattr(lib, f"crt_traverse_{kind}{tier}_persistent").argtypes = base[:-2] + [p, i, p]
    # the grid-packet kernels: B5a's and B5b's arguments without the arity
    lib.crt_traverse_closest_packet.argtypes = flat_closest[:3] + flat_closest[4:]
    lib.crt_traverse_any_packet.argtypes = flat_any[:3] + flat_any[4:]
    for kind in ("closest", "any"):
        for tier in ("", "_unified", "_stream", "_unified_stream", "_persistent",
                     "_unified_persistent", "_packet"):
            getattr(lib, f"crt_traverse_{kind}{tier}").restype = i
    # Scene*, Lanes* (ops/shade_cuda.py), R, the bounce, the stream
    lib.crt_shade_bounce.argtypes = [p, p, i, i, p]
    lib.crt_shade_bounce.restype = i
    # R1-R3 (ops/sort_cuda.py): R1's grid for R lanes; R1: orig, R, partials, counter, bounds,
    # the stream; R2: orig, dir, active, bounds, key, R, the stream; R3: perm, Wave* in,
    # Wave* out, R, the stream
    lib.crt_sort_bounds_blocks.argtypes = [i]
    lib.crt_sort_bounds.argtypes = [p, i, p, p, p, p]
    lib.crt_sort_key.argtypes = [p, p, p, p, p, i, p]
    lib.crt_sort_gather.argtypes = [p, p, p, i, p]
    for name in ("bounds_blocks", "bounds", "key", "gather"):
        getattr(lib, f"crt_sort_{name}").restype = i
    lib.crt_persistent_blocks.argtypes = [i, i, i]
    lib.crt_persistent_blocks.restype = i
    lib.crt_error_string.argtypes = [i]
    lib.crt_error_string.restype = ctypes.c_char_p
    lib.crt_max_stack.argtypes = []
    lib.crt_max_stack.restype = i
    lib.crt_max_leaf.argtypes = []
    lib.crt_max_leaf.restype = i
    if (lib.crt_max_stack(), lib.crt_max_leaf()) != (MAX_STACK, MAX_LEAF):
        raise RuntimeError(
            f"the kernels hold stack {lib.crt_max_stack()} and leaf {lib.crt_max_leaf()}, "
            f"the wrappers expect {MAX_STACK} and {MAX_LEAF}"
        )
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The kernels' library (B1-B7b, S1 and R1-R3), compiled and loaded on first
    call (load_library)."""
    with tracing.span("kernels.load"):
        return load_library(kernel_library_path())
