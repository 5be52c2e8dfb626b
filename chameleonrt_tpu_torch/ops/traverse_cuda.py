"""The fourteen traversal kernels (B1-B7b), their table and their two
launchers.

KERNELS gives each kernel its C entry, hit kind, table kind (flat or
two-level), the node row widths it takes, whether its entry takes the
rows' arity and a work-queue counter, the traversal route that runs it
(engine/trace_bvh.py choose_route) and the JAX kernel it stands for. The
routes: "lane" B1-B4 (csrc/traverse_flat.cu, csrc/traverse_unified.cu),
"stream" B5a-B5d (csrc/traverse_stream.cu,
csrc/traverse_unified_stream.cu), "persistent" B6a-B6d
(csrc/traverse_persistent.cu, persistent warps fed 32 sorted rays a fetch
from a work queue) and "packet" B7a/B7b (csrc/traverse_packet.cu, binary
rows only). Every kernel walks one ray a lane with a walk of
csrc/traverse_common.cuh: the flat closest-hit kernels share its closest
walk over a flat table, the flat any-hit kernels its any walk over one,
and the two-level kernels the same two walks over a two-level table. Each
is bit-equal to its plain version in ops/traverse.py, overflow included.

Every kernel sizes its stack as the TPU kernels do (stack_depth), up to
MAX_STACK (128) entries, and launches the instantiation of the smallest
capacity that holds it (stack_capacity: 64, or 128). A launcher checks its
inputs against what the kernel takes and raises on anything else. Then, on
CUDA tensors, it allocates the outputs (and a work-queue kernel's
counter), launches the kernel on the current stream without
synchronizing, and raises if the launch fails; on CPU tensors it runs the
plain version instead. There is no other fallback. The entries' C
signatures are bound from KERNELS at first use (library).

LAUNCHES counts kernel launches by KERNELS key, so a caller can show that
a run went through the kernels; STACK_LAUNCHES the same launches by the
stack capacity they ran with.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
from chameleonrt_tpu_torch.ops import traverse as plain

# floats per node row the kernels take: binary, BVH4 and BVH8 (B1-B6d)
ROW_FLOATS = (16, 32, 64)


class Kernel(NamedTuple):
    """One traversal kernel. Closest hit returns (t, prim, u, v) flat and
    (t, prim, inst, u, v) two-level, as the plain walk: a miss or inactive
    lane is (1e20, -1, 0, 0), and a stack overflow drops the pushes that
    do not fit and walks on, reporting prim = -2, t = 1e20 with the u, v
    of the nearest hit it found. Any hit returns (R,) bool occluded &
    mask: a ray stops at its first hit with t_min < t < t_max, and a stack
    overflow reports it occluded."""

    label: str
    entry: str  # its C entry
    hit: str  # "closest" or "any"
    two_level: bool  # a UnifiedBvh, else a flat PackedBvh
    route: str  # the traversal value that runs it: "lane", "stream", "persistent" or "packet"
    jax: str  # the JAX kernel it stands for
    widths: tuple = ROW_FLOATS  # node row widths it takes, in floats
    arity_arg: bool = True  # its entry takes the rows' arity before the leaf size
    queue: bool = False  # its entry takes a work-queue counter before R


_SL = "chameleonrt_tpu/ops/traverse_slotlane.py "
_TP = "chameleonrt_tpu/ops/traverse_packet.py "
KERNELS = {
    "closest": Kernel("B1", "crt_traverse_closest", "closest", False, "lane",
                      _SL + "traverse_closest_slotlane"),
    "any": Kernel("B2", "crt_traverse_any", "any", False, "lane", _SL + "traverse_any_slotlane"),
    "closest_unified": Kernel("B3", "crt_traverse_closest_unified", "closest", True, "lane",
                              _SL + "traverse_closest_unified_slotlane"),
    "any_unified": Kernel("B4", "crt_traverse_any_unified", "any", True, "lane",
                          _SL + "traverse_any_unified_slotlane"),
    "closest_stream": Kernel("B5a", "crt_traverse_closest_stream", "closest", False, "stream",
                             _SL + "traverse_closest_slotlane, stream=True"),
    "any_stream": Kernel("B5b", "crt_traverse_any_stream", "any", False, "stream",
                         _SL + "traverse_any_slotlane, stream=True"),
    "closest_unified_stream": Kernel("B5c", "crt_traverse_closest_unified_stream", "closest", True,
                                     "stream", _SL + "traverse_closest_unified_slotlane, stream=True"),
    "any_unified_stream": Kernel("B5d", "crt_traverse_any_unified_stream", "any", True, "stream",
                                 _SL + "traverse_any_unified_slotlane, stream=True"),
    # one kernel serves both of the JAX package's stream values
    "closest_persistent": Kernel("B6a", "crt_traverse_closest_persistent", "closest", False,
                                 "persistent", _TP + "traverse_closest_persistent (:2029)",
                                 queue=True),
    "any_persistent": Kernel("B6b", "crt_traverse_any_persistent", "any", False, "persistent",
                             _TP + "traverse_any_persistent (:2110)", queue=True),
    "closest_unified_persistent": Kernel("B6c", "crt_traverse_closest_unified_persistent",
                                         "closest", True, "persistent",
                                         _TP + "traverse_closest_unified_persistent (:1785)",
                                         queue=True),
    "any_unified_persistent": Kernel("B6d", "crt_traverse_any_unified_persistent", "any", True,
                                     "persistent", _TP + "traverse_any_unified_persistent (:1849)",
                                     queue=True),
    # the JAX kernels walk a packet of rays with one stack; these one ray a lane
    "closest_packet": Kernel("B7a", "crt_traverse_closest_packet", "closest", False, "packet",
                             _TP + "traverse_closest_packet (:627)", widths=(16,),
                             arity_arg=False),
    "any_packet": Kernel("B7b", "crt_traverse_any_packet", "any", False, "packet",
                         _TP + "traverse_any_packet (:660)", widths=(16,), arity_arg=False),
}
LAUNCHES = {key: 0 for key in KERNELS}
STACK_LAUNCHES = {key: {cap: 0 for cap in _build.STACK_CAPACITIES} for key in KERNELS}


def kernel_for(route: str, hit: str, two_level: bool) -> str:
    """The KERNELS key of the route's kernel for the hit kind and table
    kind; KeyError where there is none (no two-level "packet" kernel)."""
    for key, k in KERNELS.items():
        if (k.route, k.hit, k.two_level) == (route, hit, two_level):
            return key
    raise KeyError(f"no {'two-level' if two_level else 'flat'} {hit}-hit kernel on route {route!r}")


def _argtypes(k: Kernel) -> list:
    """The kernel's C signature: nodes, leaf rows, the table's sizes
    (leaves; or triangle leaves and tlas_lo), [arity], leaf size, depth,
    capacity, the rays (orig, dir, t_min, t_max, mask), the outputs,
    [the queue's counter], R, the stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    outs = 1 if k.hit == "any" else 5 if k.two_level else 4
    return [p, p, *[i] * (1 + k.two_level + k.arity_arg), i, i, i, *[p] * (5 + outs + k.queue),
            i, p]


@functools.lru_cache(maxsize=None)
def _bind(lib):
    """Bind the traversal entries of a loaded kernels' library, once, and
    check its stack and leaf limits against the wrappers'."""
    i = ctypes.c_int
    for k in KERNELS.values():
        getattr(lib, k.entry).argtypes = _argtypes(k)
        getattr(lib, k.entry).restype = i
    # the work-queue kernels' grid: lanes, arity, capacity
    lib.crt_persistent_blocks.argtypes = [i, i, i]
    lib.crt_persistent_blocks.restype = i
    for name in ("crt_max_stack", "crt_max_leaf"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    if (lib.crt_max_stack(), lib.crt_max_leaf()) != (_build.MAX_STACK, _build.MAX_LEAF):
        raise RuntimeError(
            f"the kernels hold stack {lib.crt_max_stack()} and leaf {lib.crt_max_leaf()}, "
            f"the wrappers expect {_build.MAX_STACK} and {_build.MAX_LEAF}"
        )
    return lib


def library() -> ctypes.CDLL:
    """The kernels' library (_build.kernels) with its traversal entries
    bound."""
    return _bind(_build.kernels())


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


def _check(k: Kernel, table, orig, dir, t_min, t_max, flag):
    """Validate everything kernel k takes; raise on anything else: a table
    of its kind, node rows of a width in k.widths (a width of 8A floats is
    arity A), and a stack depth up to the kernels' MAX_STACK (128); for a
    two-level table also the bounds of its sections. Returns (arity, leaf
    size, stack depth)."""
    kind = UnifiedBvh if k.two_level else PackedBvh
    if not isinstance(table, kind):
        raise ValueError(f"{k.label} takes a {kind.__name__}, got {type(table).__name__}")
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
    if table.nodes.dim() != 2 or table.nodes.shape[1] not in k.widths:
        raise ValueError(f"the kernels take node rows of {' or '.join(map(str, k.widths))} floats, "
                         f"got {tuple(table.nodes.shape)}")
    L = table.leaf_size
    if table.leaf_rows.dim() != 2 or table.leaf_rows.shape[1] != 10 * L or not 1 <= L <= _build.MAX_LEAF:
        raise ValueError(f"leaf rows of shape {tuple(table.leaf_rows.shape)} are not supported")
    depth = stack_depth(table)
    if depth > _build.MAX_STACK:
        raise ValueError(f"stack depth {depth} exceeds the kernel's {_build.MAX_STACK}")
    if table.nodes.data_ptr() % 16 or table.leaf_rows.data_ptr() % 16:
        raise ValueError("node and leaf rows must be 16-byte aligned")
    if k.two_level:
        if 10 * L < 14:
            raise ValueError(f"leaf rows of {10 * L} floats cannot hold an instance-entry row (14)")
        if not 0 <= table.tlas_lo < table.nodes.shape[0]:
            raise ValueError(f"tlas_lo {table.tlas_lo} is outside the {table.nodes.shape[0]} node rows")
        if not 0 <= table.n_tri_leaves < table.leaf_rows.shape[0]:
            raise ValueError(f"n_tri_leaves {table.n_tri_leaves} leaves no instance-entry rows")
    return table.nodes.shape[1] // 8, L, depth


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch(key: str, table, arity: int, L: int, depth: int, cap: int, rays, outs):
    """Call kernel key's C entry on rays (orig, dir, t_min, t_max, mask)
    into outs; raise if the launch failed, else count it."""
    k = KERNELS[key]
    lib = library()
    orig = rays[0]
    # a work-queue kernel's counter, which its entry resets in stream order before the launch
    queue = [torch.empty((1,), dtype=torch.int32, device=orig.device)] if k.queue else []
    sizes = [table.n_tri_leaves, table.tlas_lo] if k.two_level else [table.num_leaves]
    err = getattr(lib, k.entry)(
        table.nodes.data_ptr(), table.leaf_rows.data_ptr(), *sizes, *[arity] * k.arity_arg,
        L, depth, cap, *(x.data_ptr() for x in (*rays, *outs, *queue)), orig.shape[0],
        _stream(orig),
    )
    if err != 0:
        raise RuntimeError(f"{k.entry} launch failed: {lib.crt_error_string(err).decode()}")
    LAUNCHES[key] += 1
    STACK_LAUNCHES[key][cap] += 1


def launch_closest(key: str, table, orig, dir, t_min, active, t_max):
    """Closest hit through the kernel of KERNELS key (Kernel gives the
    results); on CPU tensors the plain walk's own."""
    k = KERNELS[key]
    arity, L, depth = _check(k, table, orig, dir, t_min, t_max, active)
    cap = stack_capacity(depth)
    if orig.device.type == "cpu":
        walk = plain.traverse_closest_unified if k.two_level else plain.traverse_closest
        return walk(table, orig, dir, t_min, active, t_max)
    R = orig.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=orig.device)
    prim = torch.empty((R,), dtype=torch.int32, device=orig.device)
    inst = [torch.empty_like(prim)] if k.two_level else []
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    outs = (t, prim, *inst, u, v)
    if R:
        _launch(key, table, arity, L, depth, cap, (orig, dir, t_min, t_max, active), outs)
    return outs


def launch_any(key: str, table, orig, dir, t_min, t_max, mask):
    """Any hit through the kernel of KERNELS key (Kernel gives the
    result); on CPU tensors the plain walk's own."""
    k = KERNELS[key]
    arity, L, depth = _check(k, table, orig, dir, t_min, t_max, mask)
    cap = stack_capacity(depth)
    if orig.device.type == "cpu":
        walk = plain.traverse_any_unified if k.two_level else plain.traverse_any
        return walk(table, orig, dir, t_min, t_max, mask)
    occ = torch.empty((orig.shape[0],), dtype=torch.bool, device=orig.device)
    if orig.shape[0]:
        _launch(key, table, arity, L, depth, cap, (orig, dir, t_min, t_max, mask), (occ,))
    return occ


def _binding(key: str):
    """The public wrapper of kernel key: its launcher with the key bound;
    closest hit takes (table, orig, dir, t_min, active, t_max), any hit
    (table, orig, dir, t_min, t_max, mask)."""
    k = KERNELS[key]
    fn = functools.partial(launch_closest if k.hit == "closest" else launch_any, key)
    fn.__name__ = f"traverse_{key}"
    fn.__doc__ = (f"{k.label}: {k.hit} hit over a {'two-level' if k.two_level else 'flat'} table "
                  f"({k.entry}), standing for {k.jax}.")
    return fn


traverse_closest = _binding("closest")
traverse_any = _binding("any")
traverse_closest_unified = _binding("closest_unified")
traverse_any_unified = _binding("any_unified")
traverse_closest_stream = _binding("closest_stream")
traverse_any_stream = _binding("any_stream")
traverse_closest_unified_stream = _binding("closest_unified_stream")
traverse_any_unified_stream = _binding("any_unified_stream")
traverse_closest_persistent = _binding("closest_persistent")
traverse_any_persistent = _binding("any_persistent")
traverse_closest_unified_persistent = _binding("closest_unified_persistent")
traverse_any_unified_persistent = _binding("any_unified_persistent")
traverse_closest_packet = _binding("closest_packet")
traverse_any_packet = _binding("any_packet")
