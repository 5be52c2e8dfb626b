"""Wrappers of the traversal kernels: B1 (flat closest hit) and B2 (flat any
hit) in csrc/traverse_flat.cu, B3 (two-level closest hit) and B4
(two-level any hit) in csrc/traverse_unified.cu, the streamed tier: B5a
(flat closest hit) and B5b (flat any hit) in csrc/traverse_stream.cu, B5c
(two-level closest hit) and B5d (two-level any hit) in
csrc/traverse_unified_stream.cu, and the work-queue
persistent kernels in csrc/traverse_persistent.cu: B6a (flat closest
hit), B6b (flat any hit), B6c (two-level closest hit) and B6d (two-level
any hit), and the grid-packet kernels in csrc/traverse_packet.cu: B7a
(flat closest hit) and B7b (flat any hit) on binary rows. Each walks one
ray a lane with a walk of csrc/traverse_common.cuh: B1, B5a, B6a and B7a
share its closest walk over a flat table, B2, B5b, B6b and B7b its any
walk over one, and B3/B4, B5c/B5d and B6c/B6d the same two walks over
a two-level table.

B1-B5d replace the Pallas slot-lane kernels of
chameleonrt_tpu/ops/traverse_slotlane.py (traverse_closest_slotlane,
traverse_any_slotlane, traverse_closest_unified_slotlane and
traverse_any_unified_slotlane; B5a-B5d the same four with stream=True);
B6a-B6d the work-queue kernels of chameleonrt_tpu/ops/traverse_packet.py
(traverse_closest_persistent, traverse_any_persistent,
traverse_closest_unified_persistent and traverse_any_unified_persistent,
with either `stream` value); B7a/B7b the grid-packet kernels of
traverse_packet.py (traverse_closest_packet, traverse_any_packet). B1-B6d
take node rows of arity 2, 4 or 8 (16, 32 or 64 floats), as the TPU
kernels do, B7a/B7b binary rows only. Every kernel sizes its stack as the
TPU kernels do (stack_depth), up to MAX_STACK (128) entries, and launches
the instantiation of the smallest capacity that holds it (stack_capacity:
64, or 128). Every kernel walks one ray a lane. A wrapper checks its
inputs against what the kernel takes and raises on anything else. Then,
on CUDA tensors, it allocates the outputs (and a work-queue kernel's
counter), launches the kernel on the current stream without
synchronizing, and raises if the launch fails; on CPU tensors it runs the
plain version in ops/traverse.py instead. There is no other fallback.

LAUNCHES counts kernel launches, one per launch, so a caller can show that
a run went through the kernels; STACK_LAUNCHES the same launches by the
stack capacity they ran with.
"""

from __future__ import annotations

import ctypes

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
from chameleonrt_tpu_torch.ops import traverse as plain

LAUNCHES = {"closest": 0, "any": 0, "closest_unified": 0, "any_unified": 0,
            "closest_stream": 0, "any_stream": 0,
            "closest_unified_stream": 0, "any_unified_stream": 0,
            "closest_persistent": 0, "any_persistent": 0,
            "closest_unified_persistent": 0, "any_unified_persistent": 0,
            "closest_packet": 0, "any_packet": 0}
STACK_LAUNCHES = {key: {cap: 0 for cap in _build.STACK_CAPACITIES} for key in LAUNCHES}
# floats per node row the kernels take: binary, BVH4 and BVH8 (B1-B6d)
ROW_FLOATS = (16, 32, 64)


def stack_depth(table) -> int:
    """The kernels' stack size: the builder's certified bound plus one, as
    the TPU kernels size theirs (max_depth + 1 flat, stack_bound + 1
    two-level; traverse_slotlane.py:926, :1148), without the cap of the
    plain versions (plain.stack_limit, plain.unified_stack_limit), which
    follow the XLA oracle. A push onto a full stack (depth - 1 entries) is
    an overflow."""
    bound = table.stack_bound if isinstance(table, UnifiedBvh) else table.max_depth
    return max(2, int(bound) + 1)


def stack_capacity(depth: int) -> int:
    """The stack capacity of the kernels' instantiation that a stack of
    depth entries launches: the smallest of
    _build.STACK_CAPACITIES (64, 128) that holds it, so BVH4 tables keep
    the 64-entry array. Raises above MAX_STACK."""
    for cap in _build.STACK_CAPACITIES:
        if depth <= cap:
            return cap
    raise ValueError(f"stack depth {depth} exceeds the kernel's {_build.MAX_STACK}")


def _check(table, orig, dir, t_min, t_max, flag, widths=ROW_FLOATS):
    """Validate everything the kernels take; raise on anything else:
    node rows of a width in widths (a width of 8A floats is arity A), and a
    stack depth up to the kernels' MAX_STACK (128). Returns (arity, leaf
    size, stack depth)."""
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
    if table.nodes.dim() != 2 or table.nodes.shape[1] not in widths:
        raise ValueError(f"the kernels take node rows of {' or '.join(map(str, widths))} floats, "
                         f"got {tuple(table.nodes.shape)}")
    L = table.leaf_size
    if table.leaf_rows.dim() != 2 or table.leaf_rows.shape[1] != 10 * L or not 1 <= L <= _build.MAX_LEAF:
        raise ValueError(f"leaf rows of shape {tuple(table.leaf_rows.shape)} are not supported")
    depth = stack_depth(table)
    if depth > _build.MAX_STACK:
        raise ValueError(f"stack depth {depth} exceeds the kernel's {_build.MAX_STACK}")
    if table.nodes.data_ptr() % 16 or table.leaf_rows.data_ptr() % 16:
        raise ValueError("node and leaf rows must be 16-byte aligned")
    return table.nodes.shape[1] // 8, L, depth


def _check_unified(ubvh: UnifiedBvh, orig, dir, t_min, t_max, flag):
    """_check for a two-level table, plus the bounds of its sections."""
    arity, L, depth = _check(ubvh, orig, dir, t_min, t_max, flag)
    if 10 * L < 14:
        raise ValueError(f"leaf rows of {10 * L} floats cannot hold an instance-entry row (14)")
    if not 0 <= ubvh.tlas_lo < ubvh.nodes.shape[0]:
        raise ValueError(f"tlas_lo {ubvh.tlas_lo} is outside the {ubvh.nodes.shape[0]} node rows")
    if not 0 <= ubvh.n_tri_leaves < ubvh.leaf_rows.shape[0]:
        raise ValueError(f"n_tri_leaves {ubvh.n_tri_leaves} leaves no instance-entry rows")
    return arity, L, depth


def _check_packet(pbvh: PackedBvh, orig, dir, t_min, t_max, flag):
    """_check for the grid-packet kernels (B7a, B7b): a flat table of binary
    rows only. Returns (arity, leaf size, stack depth)."""
    if not isinstance(pbvh, PackedBvh):
        raise ValueError(f"the grid-packet kernels take a flat PackedBvh, got {type(pbvh).__name__}")
    return _check(pbvh, orig, dir, t_min, t_max, flag, widths=(16,))


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _queue(entry: str, x) -> list:
    """The extra argument of a work-queue kernel's C entry (B6a-B6d): one
    int32 of x's device for the queue's counter, which the entry resets in
    stream order before its launch. Other entries take none."""
    if not entry.endswith("_persistent"):
        return []
    return [torch.empty((1,), dtype=torch.int32, device=x.device)]


def _raise_on(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.crt_error_string(err).decode()}")


def _arity_arg(entry: str, arity: int) -> list:
    """The arity argument of a C entry: B1-B6d take one before the leaf
    size, the grid-packet kernels (binary rows only) none."""
    return [] if entry.endswith("_packet") else [arity]


def _count(key: str, cap: int):
    LAUNCHES[key] += 1
    STACK_LAUNCHES[key][cap] += 1


def _closest(entry: str, key: str, pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """A flat closest-hit kernel (B1, B5a, B6a or B7a) through its C entry point."""
    check = _check_packet if entry.endswith("_packet") else _check
    arity, L, depth = check(pbvh, orig, dir, t_min, t_max, active)
    cap = stack_capacity(depth)
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
    queue = _queue(entry, orig)
    err = getattr(lib, entry)(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves,
        *_arity_arg(entry, arity), L, depth, cap,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        active.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        *[q.data_ptr() for q in queue], R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    _count(key, cap)
    return t, prim, u, v


def _any(entry: str, key: str, pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """A flat any-hit kernel (B2, B5b, B6b or B7b) through its C entry point."""
    check = _check_packet if entry.endswith("_packet") else _check
    arity, L, depth = check(pbvh, orig, dir, t_min, t_max, mask)
    cap = stack_capacity(depth)
    if orig.device.type == "cpu":
        return plain.traverse_any(pbvh, orig, dir, t_min, t_max, mask)
    lib = _build.kernels()
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=orig.device)
    if R == 0:
        return occ
    queue = _queue(entry, orig)
    err = getattr(lib, entry)(
        pbvh.nodes.data_ptr(), pbvh.leaf_rows.data_ptr(), pbvh.num_leaves,
        *_arity_arg(entry, arity), L, depth, cap,
        orig.data_ptr(), dir.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        mask.data_ptr(), occ.data_ptr(), *[q.data_ptr() for q in queue], R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    _count(key, cap)
    return occ


def traverse_closest(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B1: closest hit, one lane per ray in the plain walk's order (B3's walk
    over a flat table, as B5a). Returns (t, prim, u, v), bit-equal to its
    plain version, plain.traverse_closest: a miss or inactive lane is
    (1e20, -1, 0, 0), and a stack overflow drops the pushes that do not
    fit and walks on, reporting prim = -2, t = 1e20 with the u, v of the
    nearest hit it found, as the plain walk does."""
    return _closest("crt_traverse_closest", "closest", pbvh, orig, dir, t_min, active, t_max)


def traverse_any(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B2: any hit, one lane per ray in the plain walk's order (B4's walk
    over a flat table, as B5b). Returns (R,) bool occluded & mask, bit-equal
    to its plain version, plain.traverse_any: a ray stops at its first hit
    with t_min < t < t_max, and a stack overflow reports it occluded, as
    the plain walk does."""
    return _any("crt_traverse_any", "any", pbvh, orig, dir, t_min, t_max, mask)


def traverse_closest_stream(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B5a: closest hit of the streamed tier, one lane per ray in the plain
    walk's order (B3's walk over a flat table). Returns (t, prim, u, v),
    bit-equal to its plain version, plain.traverse_closest: B5a computes
    the same function on the same BVH4 table, as the JAX suite holds the
    stream=True slot-lane kernel against the VMEM one
    (tests/test_traverse_slotlane.py)."""
    return _closest("crt_traverse_closest_stream", "closest_stream",
                    pbvh, orig, dir, t_min, active, t_max)


def traverse_any_stream(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B5b: any hit of the streamed tier, one lane per ray in the plain
    walk's order (B4's walk over a flat table). Returns (R,) bool occluded
    & mask, bit-equal to its plain version, plain.traverse_any."""
    return _any("crt_traverse_any_stream", "any_stream", pbvh, orig, dir, t_min, t_max, mask)


def _closest_unified(entry: str, key: str, ubvh: UnifiedBvh, orig, dir, t_min, active, t_max):
    """A two-level closest-hit kernel (B3, B5c or B6c) through its C entry point."""
    arity, L, depth = _check_unified(ubvh, orig, dir, t_min, t_max, active)
    cap = stack_capacity(depth)
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
    queue = _queue(entry, orig)
    err = getattr(lib, entry)(
        ubvh.nodes.data_ptr(), ubvh.leaf_rows.data_ptr(), ubvh.n_tri_leaves, ubvh.tlas_lo, arity,
        L, depth, cap, orig.data_ptr(), dir.data_ptr(),
        t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), t.data_ptr(), prim.data_ptr(),
        inst.data_ptr(), u.data_ptr(), v.data_ptr(), *[q.data_ptr() for q in queue], R,
        _stream(orig),
    )
    _raise_on(lib, err, entry)
    _count(key, cap)
    return t, prim, inst, u, v


def _any_unified(entry: str, key: str, ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """A two-level any-hit kernel (B4, B5d or B6d) through its C entry point."""
    arity, L, depth = _check_unified(ubvh, orig, dir, t_min, t_max, mask)
    cap = stack_capacity(depth)
    if orig.device.type == "cpu":
        return plain.traverse_any_unified(ubvh, orig, dir, t_min, t_max, mask)
    lib = _build.kernels()
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=orig.device)
    if R == 0:
        return occ
    queue = _queue(entry, orig)
    err = getattr(lib, entry)(
        ubvh.nodes.data_ptr(), ubvh.leaf_rows.data_ptr(), ubvh.n_tri_leaves, ubvh.tlas_lo, arity,
        L, depth, cap, orig.data_ptr(), dir.data_ptr(),
        t_min.data_ptr(), t_max.data_ptr(), mask.data_ptr(), occ.data_ptr(),
        *[q.data_ptr() for q in queue], R, _stream(orig),
    )
    _raise_on(lib, err, entry)
    _count(key, cap)
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
    """B5c: closest hit over a two-level table in the streamed tier, B3's
    per-ray walk in a kernel of its own. Returns (t, prim, inst, u, v),
    bit-equal to its plain version, plain.traverse_closest_unified."""
    return _closest_unified("crt_traverse_closest_unified_stream", "closest_unified_stream",
                            ubvh, orig, dir, t_min, active, t_max)


def traverse_any_unified_stream(ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """B5d: any hit over a two-level table in the streamed tier, as B5c in
    B4's order. Returns (R,) bool occluded & mask; its plain version is
    plain.traverse_any_unified, with which it agrees lane for lane."""
    return _any_unified("crt_traverse_any_unified_stream", "any_unified_stream",
                        ubvh, orig, dir, t_min, t_max, mask)


def traverse_closest_persistent(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B6a: flat closest hit by persistent warps fed from a work queue, 32
    sorted rays a fetch, each lane walking one ray with B1's walk. Returns
    (t, prim, u, v), bit-equal to its plain version, plain.traverse_closest,
    overflow included, as B1. Replaces
    chameleonrt_tpu/ops/traverse_packet.py traverse_closest_persistent
    (pl.pallas_call of _closest_call_persistent, traverse_packet.py:2029),
    with stream False or True: on the card both are this kernel."""
    return _closest("crt_traverse_closest_persistent", "closest_persistent",
                    pbvh, orig, dir, t_min, active, t_max)


def traverse_any_persistent(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B6b: flat any hit by persistent warps fed from a work queue, 32
    sorted rays a fetch, each lane walking one ray with B2's walk. Returns
    (R,) bool occluded & mask, bit-equal to its plain version,
    plain.traverse_any, overflow included, as B2. Replaces traverse_packet.py
    traverse_any_persistent (pl.pallas_call of _any_call_persistent,
    traverse_packet.py:2110), either `stream` value."""
    return _any("crt_traverse_any_persistent", "any_persistent",
                pbvh, orig, dir, t_min, t_max, mask)


def traverse_closest_unified_persistent(ubvh: UnifiedBvh, orig, dir, t_min, active, t_max):
    """B6c: two-level closest hit from the work queue. Returns (t, prim,
    inst, u, v), as plain.traverse_closest_unified. Replaces
    traverse_packet.py traverse_closest_unified_persistent (pl.pallas_call
    of _closest_unified_call_persistent, traverse_packet.py:1785), either
    `stream` value."""
    return _closest_unified("crt_traverse_closest_unified_persistent", "closest_unified_persistent",
                            ubvh, orig, dir, t_min, active, t_max)


def traverse_any_unified_persistent(ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask):
    """B6d: two-level any hit from the work queue. Returns (R,) bool
    occluded & mask, as plain.traverse_any_unified. Replaces
    traverse_packet.py traverse_any_unified_persistent (pl.pallas_call of
    _any_unified_call_persistent, traverse_packet.py:1849), either
    `stream` value."""
    return _any_unified("crt_traverse_any_unified_persistent", "any_unified_persistent",
                        ubvh, orig, dir, t_min, t_max, mask)


def traverse_closest_packet(pbvh: PackedBvh, orig, dir, t_min, active, t_max):
    """B7a: closest hit over binary rows, one lane per ray in the plain
    walk's order (B5a's walk at arity 2). Returns (t, prim, u, v); a miss
    or inactive lane is (1e20, -1, 0, 0). Replaces
    chameleonrt_tpu/ops/traverse_packet.py traverse_closest_packet
    (pl.pallas_call of _closest_call, traverse_packet.py:627), which walks
    a packet of rays with one stack. Its plain version is
    plain.traverse_closest on the same binary table, to which it is
    bit-equal."""
    return _closest("crt_traverse_closest_packet", "closest_packet",
                    pbvh, orig, dir, t_min, active, t_max)


def traverse_any_packet(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """B7b: any hit over binary rows, one lane per ray in the plain walk's
    order (B5b's walk at arity 2). Returns (R,) bool occluded & mask.
    Replaces traverse_packet.py traverse_any_packet (pl.pallas_call of
    _any_call, traverse_packet.py:660), which walks a packet of rays with
    one stack and tests every leaf the packet visits with every live lane.
    Its plain version is plain.traverse_any on the same binary table, to
    which it is bit-equal."""
    return _any("crt_traverse_any_packet", "any_packet", pbvh, orig, dir, t_min, t_max, mask)
