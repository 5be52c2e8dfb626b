"""Wrapper of R1-R3 (csrc/sort.cu): the wavefront re-sort in three launches
around an int32 stable sort.

R1-R3 replace no Pallas kernel (the JAX package's re-sort is plain
jnp.argsort and seven gathers); they compute sort_wavefront_plain, the
plain version, lane for lane. sort_wavefront takes engine/path_tracer.py's
_sort_wavefront arguments and returns its tuple. It checks the fields
against what the kernels take and raises on anything else. Then, on CUDA
tensors, it launches on the fields' own device and that device's current
stream, without synchronizing: R1 (bounds) the origins' per-axis min and
max over every lane, R2 (keys) ray_sort_key as an int32, torch.sort(key,
stable=True), and R3 (gather) the seven fields by the permutation into
fresh tensors; it raises if a launch fails. On CPU tensors it runs
sort_wavefront_plain instead. There is no other fallback.

LAUNCHES counts R1-R3's launches (3 a re-sort), so that a caller can show
that a run re-sorted through the kernels; the tracing counter
lanes.sorted_kernel counts the lanes they sorted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.core import tracing
from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

LAUNCHES = 0

# _sort_wavefront's fields, in order: (name, dtype, components; 0 for one)
FIELDS = (("state", torch.int64, 0), ("orig", torch.float32, 3), ("dir", torch.float32, 3),
          ("throughput", torch.float32, 3), ("illum", torch.float32, 3),
          ("active", torch.bool, 0), ("lane_pixel", torch.int64, 0))

# (device index, stream) -> R1's scratch: its block counter, which R1
# leaves at 0, then 3 float4 partials a block
_SCRATCH = {}


class Wave(ctypes.Structure):
    """crt::sort::Wave (csrc/sort.cu), field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name, _, _ in FIELDS]


@functools.lru_cache(maxsize=None)
def _bind(lib):
    """Bind R1-R3's entries of a loaded kernels' library, once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # R1's grid for R lanes; R1: orig, R, partials, counter, bounds, the stream; R2: orig, dir,
    # active, bounds, key, R, the stream; R3: perm, Wave* in, Wave* out, R, the stream
    for name, argtypes in (("crt_sort_bounds_blocks", [i]), ("crt_sort_bounds", [p, i, p, p, p, p]),
                           ("crt_sort_key", [p, p, p, p, p, i, p]),
                           ("crt_sort_gather", [p, p, p, i, p])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    return lib


def _check(fields):
    """Validate the wavefront's fields against what R1-R3 take; raise on
    anything else."""
    R = fields[0].shape[0] if fields[0].dim() else 0
    dev = fields[0].device
    for (name, dtype, k), x in zip(FIELDS, fields):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, state is on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        shape = (R, k) if k else (R,)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R < 1:
        raise ValueError("a wavefront to sort has at least one lane")


def sort_wavefront_plain(state, orig, dir, throughput, illum, active, lane_pixel):
    """The plain re-sort: ray_sort_perm_only's stable permutation applied
    to every field."""
    perm = ray_sort_perm_only(orig, dir, active)
    return tuple(x[perm] for x in (state, orig, dir, throughput, illum, active, lane_pixel))


def _launch(device, entry: str, *args) -> None:
    """Call the C entry on device's current stream, with device current;
    raise if the launch failed."""
    global LAUNCHES
    lib = _bind(_build.kernels())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.crt_error_string(err).decode()}")
    LAUNCHES += 1


def bounds(orig):
    """R1: (6,) float32 on orig's device, the per-axis min of orig (R, 3)
    over all lanes, then the max; NaN on an axis where a lane is NaN."""
    dev = orig.device
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _SCRATCH:
        blocks = _bind(_build.kernels()).crt_sort_bounds_blocks(2**31 - 1)
        _SCRATCH[key] = torch.zeros(4 + 12 * blocks, dtype=torch.int32, device=dev)
    scratch = _SCRATCH[key]
    out = torch.empty(6, dtype=torch.float32, device=dev)
    _launch(dev, "crt_sort_bounds", orig.data_ptr(), orig.shape[0], scratch[4:].data_ptr(),
            scratch.data_ptr(), out.data_ptr())
    return out


def keys(orig, dir, active, lohi):
    """R2: ray_sort_key(orig, dir, active) as (R,) int32, quantised between
    R1's bounds lohi."""
    out = torch.empty(orig.shape[0], dtype=torch.int32, device=orig.device)
    _launch(orig.device, "crt_sort_key", orig.data_ptr(), dir.data_ptr(), active.data_ptr(),
            lohi.data_ptr(), out.data_ptr(), orig.shape[0])
    return out


def gather(perm, fields):
    """R3: tuple(x[perm] for x in fields), the seven fields of FIELDS, in
    one launch."""
    outs = tuple(torch.empty_like(x) for x in fields)
    _launch(perm.device, "crt_sort_gather", perm.data_ptr(),
            ctypes.byref(Wave(*(x.data_ptr() for x in fields))),
            ctypes.byref(Wave(*(x.data_ptr() for x in outs))), perm.shape[0])
    return outs


def sort_wavefront(state, orig, dir, throughput, illum, active, lane_pixel):
    """The re-sort: R1, R2, an int32 stable sort and R3 on CUDA fields;
    sort_wavefront_plain's on CPU fields. Returns the seven fields in the
    sorted order."""
    fields = (state, orig, dir, throughput, illum, active, lane_pixel)
    _check(fields)
    if orig.device.type == "cpu":
        return sort_wavefront_plain(*fields)
    if orig.shape[0] >= 2**31 // 3:
        raise ValueError(f"R2 and R3 index lanes with 32-bit ints: {orig.shape[0]} lanes is too many")
    key = keys(orig, dir, active, bounds(orig))
    perm = torch.sort(key, stable=True).indices
    out = gather(perm, fields)
    tracing.count("lanes.sorted_kernel", orig.shape[0])
    return out
