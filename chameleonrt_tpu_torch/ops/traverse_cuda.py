"""Wrappers of the traversal kernels: B1 (flat closest hit) and B2 (flat any
hit) in csrc/traverse_flat.cu, B3 (two-level closest hit) and B4
(two-level any hit) in csrc/traverse_unified.cu, and the streamed tier in
csrc/traverse_stream.cu: B5a (flat closest hit), B5b (flat any hit), B5c
(two-level closest hit) and B5d (two-level any hit).

They replace the Pallas slot-lane kernels of
chameleonrt_tpu/ops/traverse_slotlane.py (traverse_closest_slotlane,
traverse_any_slotlane, traverse_closest_unified_slotlane and
traverse_any_unified_slotlane; B5a-B5d the same four with stream=True).
Every kernel sizes its stack as the TPU kernels do (stack_depth). A
wrapper checks its inputs against what the kernel takes and raises on
anything else. Then, on CUDA tensors, it allocates the outputs, launches
the kernel on the current stream without synchronizing, and raises if the
launch fails; on CPU tensors it runs the plain version in ops/traverse.py
instead. There is no other fallback.

LAUNCHES counts kernel launches, one per launch, so a caller can show that
a run went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
from chameleonrt_tpu_torch.ops import traverse as plain

LAUNCHES = {"closest": 0, "any": 0, "closest_unified": 0, "any_unified": 0,
            "closest_stream": 0, "any_stream": 0,
            "closest_unified_stream": 0, "any_unified_stream": 0}


def stack_depth(table) -> int:
    """The kernels' stack size: the builder's certified bound plus one, as
    the TPU kernels size theirs (max_depth + 1 flat, stack_bound + 1
    two-level; traverse_slotlane.py:926, :1148), without the cap of the
    plain versions (plain.stack_limit, plain.unified_stack_limit), which
    follow the XLA oracle. A push onto a full stack (depth - 1 entries) is
    an overflow."""
    bound = table.stack_bound if isinstance(table, UnifiedBvh) else table.max_depth
    return max(2, int(bound) + 1)


def _check(table, orig, dir, t_min, t_max, flag):
    """Validate everything the kernels take; raise on anything else.
    Returns (leaf size, stack depth)."""
    R = orig.shape[0]
    want = [
        ("nodes", table.nodes, torch.float32, None),
        ("leaf_rows", table.leaf_rows, torch.float32, None),
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
    if table.nodes.dim() != 2 or table.nodes.shape[1] != 32:
        raise ValueError(f"the kernels take BVH4 rows of 32 floats, got {tuple(table.nodes.shape)}")
    L = table.leaf_size
    if table.leaf_rows.dim() != 2 or table.leaf_rows.shape[1] != 10 * L or not 1 <= L <= _build.MAX_LEAF:
        raise ValueError(f"leaf rows of shape {tuple(table.leaf_rows.shape)} are not supported")
    depth = stack_depth(table)
    if depth > _build.MAX_STACK:
        raise ValueError(f"stack depth {depth} exceeds the kernel's {_build.MAX_STACK}")
    if table.nodes.data_ptr() % 16:
        raise ValueError("node rows must be 16-byte aligned")
    return L, depth


def _check_unified(ubvh: UnifiedBvh, orig, dir, t_min, t_max, flag):
    """_check for a two-level table, plus the bounds of its sections."""
    L, depth = _check(ubvh, orig, dir, t_min, t_max, flag)
    if 10 * L < 14:
        raise ValueError(f"leaf rows of {10 * L} floats cannot hold an instance-entry row (14)")
    if not 0 <= ubvh.tlas_lo < ubvh.nodes.shape[0]:
        raise ValueError(f"tlas_lo {ubvh.tlas_lo} is outside the {ubvh.nodes.shape[0]} node rows")
    if not 0 <= ubvh.n_tri_leaves < ubvh.leaf_rows.shape[0]:
        raise ValueError(f"n_tri_leaves {ubvh.n_tri_leaves} leaves no instance-entry rows")
    return L, depth


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.crt_error_string(err).decode()}")


def _closest(entry: str, key: str, pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """A flat closest-hit kernel (B1 or B5a) through its C entry point."""
    L, depth = _check(pbvh, orig, dir, t_min, t_max, active)
    if orig.device.type == "cpu":
        return plain.traverse_closest(pbvh, orig, dir, t_min, active, t_max)
    lib = _build.kernels()
    R = orig.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=orig.device)
    prim = torch.empty((R,), dtype=torch.int32, device=orig.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if R == 0:
        return t, prim, u, v
    err = getattr(lib, entry)(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves, L, depth,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        active.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), R,
        _stream(orig),
    )
    _raise_on(lib, err, entry)
    LAUNCHES[key] += 1
    return t, prim, u, v


def _any(entry: str, key: str, pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """A flat any-hit kernel (B2 or B5b) through its C entry point."""
    L, depth = _check(pbvh, orig, dir, t_min, t_max, mask)
    if orig.device.type == "cpu":
        return plain.traverse_any(pbvh, orig, dir, t_min, t_max, mask)
    lib = _build.kernels()
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=orig.device)
    if R == 0:
        return occ
    err = getattr(lib, entry)(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves, L, depth,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        mask.data_ptr(), occ.data_ptr(), R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    LAUNCHES[key] += 1
    return occ


def traverse_closest(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B1: closest hit. Returns (t, prim, u, v), as plain.traverse_closest."""
    return _closest("crt_traverse_closest", "closest", pbvh, orig, dir, t_min, active, t_max)


def traverse_any(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B2: any hit. Returns (R,) bool occluded & mask, as plain.traverse_any."""
    return _any("crt_traverse_any", "any", pbvh, orig, dir, t_min, t_max, mask)


def traverse_closest_stream(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B5a: closest hit of the streamed tier, one warp per packet of 32
    consecutive rays. Returns (t, prim, u, v). Its plain version is
    plain.traverse_closest: B5a computes the same function on the same
    BVH4 table, as the JAX suite holds the stream=True slot-lane kernel
    against the VMEM one (tests/test_traverse_slotlane.py). t agrees; a
    prim may differ where two hits tie exactly in t, since the packet
    visits in another order."""
    return _closest("crt_traverse_closest_stream", "closest_stream",
                    pbvh, orig, dir, t_min, active, t_max)


def traverse_any_stream(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B5b: any hit of the streamed tier, one warp per packet. Returns (R,)
    bool occluded & mask; its plain version is plain.traverse_any, with
    which it agrees lane for lane."""
    return _any("crt_traverse_any_stream", "any_stream", pbvh, orig, dir, t_min, t_max, mask)


def _closest_unified(entry: str, key: str, ubvh: UnifiedBvh, orig, dir, t_min, active, t_max):
    """A two-level closest-hit kernel (B3 or B5c) through its C entry point."""
    L, depth = _check_unified(ubvh, orig, dir, t_min, t_max, active)
    if orig.device.type == "cpu":
        return plain.traverse_closest_unified(ubvh, orig, dir, t_min, active, t_max)
    lib = _build.kernels()
    R = orig.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=orig.device)
    prim = torch.empty((R,), dtype=torch.int32, device=orig.device)
    inst = torch.empty_like(prim)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if R == 0:
        return t, prim, inst, u, v
    err = getattr(lib, entry)(
        ubvh.nodes.data_ptr(), ubvh.leaf_rows.data_ptr(), ubvh.n_tri_leaves, ubvh.tlas_lo, L,
        depth, orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        active.data_ptr(), t.data_ptr(), prim.data_ptr(), inst.data_ptr(), u.data_ptr(),
        v.data_ptr(), R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    LAUNCHES[key] += 1
    return t, prim, inst, u, v


def _any_unified(entry: str, key: str, ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """A two-level any-hit kernel (B4 or B5d) through its C entry point."""
    L, depth = _check_unified(ubvh, orig, dir, t_min, t_max, mask)
    if orig.device.type == "cpu":
        return plain.traverse_any_unified(ubvh, orig, dir, t_min, t_max, mask)
    lib = _build.kernels()
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=orig.device)
    if R == 0:
        return occ
    err = getattr(lib, entry)(
        ubvh.nodes.data_ptr(), ubvh.leaf_rows.data_ptr(), ubvh.n_tri_leaves, ubvh.tlas_lo, L,
        depth, orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        mask.data_ptr(), occ.data_ptr(), R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    LAUNCHES[key] += 1
    return occ


def traverse_closest_unified(ubvh: UnifiedBvh, orig, dir, t_min, active, t_max):
    """B3: closest hit over a two-level table. Returns (t, prim, inst, u,
    v), as plain.traverse_closest_unified."""
    return _closest_unified("crt_traverse_closest_unified", "closest_unified",
                            ubvh, orig, dir, t_min, active, t_max)


def traverse_any_unified(ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """B4: any hit over a two-level table. Returns (R,) bool occluded &
    mask, as plain.traverse_any_unified."""
    return _any_unified("crt_traverse_any_unified", "any_unified",
                        ubvh, orig, dir, t_min, t_max, mask)


def traverse_closest_unified_stream(ubvh: UnifiedBvh, orig, dir, t_min, active, t_max):
    """B5c: closest hit over a two-level table in the streamed tier, one
    warp per packet of 32 consecutive rays. Returns (t, prim, inst, u, v);
    its plain version is plain.traverse_closest_unified. As with B5a, t
    agrees; a prim may differ only where two hits tie exactly in t."""
    return _closest_unified("crt_traverse_closest_unified_stream", "closest_unified_stream",
                            ubvh, orig, dir, t_min, active, t_max)


def traverse_any_unified_stream(ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """B5d: any hit over a two-level table in the streamed tier, one warp
    per packet. Returns (R,) bool occluded & mask; its plain version is
    plain.traverse_any_unified, with which it agrees lane for lane."""
    return _any_unified("crt_traverse_any_unified_stream", "any_unified_stream",
                        ubvh, orig, dir, t_min, t_max, mask)
