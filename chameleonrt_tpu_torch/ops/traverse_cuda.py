"""Wrappers of the flat traversal kernels B1 (closest hit) and B2 (any hit),
csrc/traverse_flat.cu.

They replace the Pallas slot-lane kernels of
chameleonrt_tpu/ops/traverse_slotlane.py (traverse_closest_slotlane and
traverse_any_slotlane). On CUDA tensors a wrapper checks its inputs,
allocates the outputs, launches the kernel on the current stream without
synchronizing, and raises if the launch fails. On CPU tensors it runs the
plain version in ops/traverse.py instead. There is no other fallback.

LAUNCHES counts kernel launches, one per launch, so a caller can show that
a run went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh
from chameleonrt_tpu_torch.ops import traverse as plain

LAUNCHES = {"closest": 0, "any": 0}


def _check(pbvh: PackedBvh, orig, dir, t_min, t_max, flag):
    """Validate everything the kernels take; raise on anything else."""
    R = orig.shape[0]
    lib = _build.kernels()
    want = [
        ("nodes", pbvh.nodes, torch.float32, None),
        ("leaf_rows", pbvh.leaf_rows, torch.float32, None),
        ("orig", orig, torch.float32, (R, 3)),
        ("dir", dir, torch.float32, (R, 3)),
        ("t_min", t_min, torch.float32, (R,)),
        ("t_max", t_max, torch.float32, (R,)),
        ("mask", flag, torch.bool, (R,)),
    ]
    dev = orig.device
    for name, x, dtype, shape in want:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pbvh.arity != 4:
        raise ValueError(f"the flat kernels take BVH4 rows, got arity {pbvh.arity}")
    L = pbvh.leaf_size
    if pbvh.leaf_rows.shape[1] != 10 * L or not 1 <= L <= lib.crt_max_leaf():
        raise ValueError(f"leaf rows of width {pbvh.leaf_rows.shape[1]} are not supported")
    depth = plain.stack_limit(pbvh)
    if depth > lib.crt_max_stack():
        raise ValueError(f"stack depth {depth} exceeds the kernel's {lib.crt_max_stack()}")
    if pbvh.nodes.data_ptr() % 16:
        raise ValueError("node rows must be 16-byte aligned")
    return lib, L, depth


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.crt_error_string(err).decode()}")


def traverse_closest(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B1: closest hit. Returns (t, prim, u, v), as plain.traverse_closest."""
    if orig.device.type == "cpu":
        return plain.traverse_closest(pbvh, orig, dir, t_min, active, t_max)
    lib, L, depth = _check(pbvh, orig, dir, t_min, t_max, active)
    R = orig.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=orig.device)
    prim = torch.empty((R,), dtype=torch.int32, device=orig.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if R == 0:
        return t, prim, u, v
    err = lib.crt_traverse_closest(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves, L, depth,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        active.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), R,
        ctypes.c_void_p(torch.cuda.current_stream(orig.device).cuda_stream),
    )
    _raise_on(lib, err, "closest-hit kernel")
    LAUNCHES["closest"] += 1
    return t, prim, u, v


def traverse_any(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B2: any hit. Returns (R,) bool occluded & mask, as plain.traverse_any."""
    if orig.device.type == "cpu":
        return plain.traverse_any(pbvh, orig, dir, t_min, t_max, mask)
    lib, L, depth = _check(pbvh, orig, dir, t_min, t_max, mask)
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=orig.device)
    if R == 0:
        return occ
    err = lib.crt_traverse_any(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves, L, depth,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        mask.data_ptr(), occ.data_ptr(), R,
        ctypes.c_void_p(torch.cuda.current_stream(orig.device).cuda_stream),
    )
    _raise_on(lib, err, "any-hit kernel")
    LAUNCHES["any"] += 1
    return occ
