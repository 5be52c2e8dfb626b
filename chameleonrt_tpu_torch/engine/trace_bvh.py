"""BVH tables and scene traversal (torch): the counterpart of
chameleonrt_tpu/engine/trace_bvh.py.

Each mesh gets one native binned-SAH build (native/bvhbuilder.cpp,
compiled at first use by chameleonrt_tpu_torch/native.py), which emits a
binary table and a wide table (BVH4, or BVH8 under
CHAMELEONRT_WIDE_ARITY=8) over shared leaf rows, unpadded.

- A single-instance (flat) scene keeps one BlasPair per mesh: rays move
  into the instance's object space and traverse its mesh's tables.
- A multi-instance scene fuses every mesh's BLAS and a TLAS over the
  instances' world boxes into one UnifiedPair, and one launch traces the
  whole two-level scene.
- Where the native builder is unavailable (no C++ compiler), each mesh
  gets an LBVH built on the device (ops/lbvh.py): one binary table with
  its certified height, which the same kernels trace at arity 2. A flat
  scene traces its mesh's table; a multi-instance one goes instance by
  instance, each walk culled by the instance's world box, as the JAX
  engine does without its builder.

Which kernels (or the plain walk) trace which table is the route, one
value (traversal) that choose_route maps, with the environment and the
scene, as its table states. The table switches are read as the JAX
package's engine/trace_bvh.py reads them, with its error messages:
CHAMELEONRT_CLOSEST_ARITY=2 traces closest hit on the binary table
(closest_arity), CHAMELEONRT_WIDE_ARITY (4 or 8) and CHAMELEONRT_LEAF_SIZE
(2-12) shape the builds (wide_arity, native_leaf_size), and
CHAMELEONRT_PACKET and CHAMELEONRT_SLOTLANE move the route
(choose_route).

The kernels, their table and their launchers are in ops/traverse_cuda.py,
their plain versions in ops/traverse.py.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine.device_scene import (
    BlasPair,
    FlatScene,
    PackedBvh,
    SceneMeta,
    UnifiedBvh,
    UnifiedPair,
    host_triangles,
)
from chameleonrt_tpu_torch.ops import lbvh
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.ops.intersect import T_MAX, Hit
from chameleonrt_tpu_torch.ops.math import EPSILON, transform_point, transform_vector

def closest_arity() -> int:
    """Children per row of the table that closest hit traces: 2 (the
    binary table) where CHAMELEONRT_CLOSEST_ARITY is "2", else the wide
    arity, as the JAX package's _closest_table chooses."""
    if os.environ.get("CHAMELEONRT_CLOSEST_ARITY") == "2":
        return 2
    return wide_arity()


def wide_arity() -> int:
    """Children per wide row of the native builds: CHAMELEONRT_WIDE_ARITY,
    4 (the default) or 8, as the JAX package's _wide_arity reads it."""
    try:
        w = int(os.environ.get("CHAMELEONRT_WIDE_ARITY", "4"))
    except ValueError:
        raise ValueError("CHAMELEONRT_WIDE_ARITY must be an integer") from None
    if w not in (4, 8):
        raise ValueError("CHAMELEONRT_WIDE_ARITY must be 4 or 8")
    return w


def native_leaf_size() -> int:
    """Triangles per leaf row of the native BLAS builds:
    CHAMELEONRT_LEAF_SIZE, 4 (the default) or any of 2-12, as the JAX
    package's _native_leaf_size reads it."""
    try:
        s = int(os.environ.get("CHAMELEONRT_LEAF_SIZE", "4"))
    except ValueError:
        raise ValueError("CHAMELEONRT_LEAF_SIZE must be an integer") from None
    if not 2 <= s <= 12:
        raise ValueError("CHAMELEONRT_LEAF_SIZE must be in [2, 12]")
    return s


def _native_build(v0, e1, e2, leaf_size: int, arity: int):
    """One native SAH build: (nodes2, nodes_wide, leaf_rows, depth2,
    stack_wide). Raises if the native builder is unavailable."""
    if native.get_lib() is None:
        raise RuntimeError("the native SAH builder (native/) is unavailable: no C++ compiler")
    res = native.build_bvh_pair_native(v0, e1, e2, leaf_size, wide_arity=arity)
    if res is None:
        raise RuntimeError(f"native SAH build of {len(v0)} triangles returned no tables")
    return res


def _lbvh_blas_set(flat: FlatScene, meta: SceneMeta) -> Tuple:
    """One LBVH per mesh (ops/lbvh.py), built on the scene's device, its
    binary table in both slots of a BlasPair, unpadded, its max_depth the
    tree's height: the counterpart of the JAX engine's fallback where its
    native builder is unavailable (chameleonrt_tpu/engine/trace_bvh.py
    build_blas_set)."""
    blas = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        packed = lbvh.build_packed(flat.tri_v0[sl], flat.tri_e1[sl], flat.tri_e2[sl])
        blas.append(BlasPair(closest=packed, any=packed))
    return tuple(blas)


def build_blas_set(flat: FlatScene, meta: SceneMeta) -> Tuple:
    """The scene's BVH tables: (UnifiedPair,) for a multi-instance scene,
    otherwise one BlasPair per mesh with leaf prim ids local to the mesh's
    range. Leaf size and wide arity come from native_leaf_size and
    wide_arity. Where the native SAH builder is unavailable (no C++
    compiler: native.get_lib() is None), every scene, multi-instance ones
    too, gets one LBVH BlasPair per mesh instead (_lbvh_blas_set)."""
    if native.get_lib() is None:
        return _lbvh_blas_set(flat, meta)
    if meta.num_instances > 1:
        return (build_unified_set(flat, meta),)
    v0, e1, e2 = host_triangles(flat)
    dev = flat.shade_rows.device
    L, arity = native_leaf_size(), wide_arity()
    blas = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        nodes2, nodes4, leaf_rows, depth2, stack4 = _native_build(v0[sl], e1[sl], e2[sl], L, arity)
        leaf = torch.as_tensor(leaf_rows, device=dev)
        blas.append(
            BlasPair(
                closest=PackedBvh(torch.as_tensor(nodes2, device=dev), leaf, depth2),
                any=PackedBvh(torch.as_tensor(nodes4, device=dev), leaf, stack4),
            )
        )
    return tuple(blas)


def _rebase_codes(nodes: np.ndarray, arity: int, node_off: int, leaf_map) -> None:
    """Rebase the child codes of a packed node table in place: internal
    codes shift by node_off; leaf codes c < 0 map through leaf_map(leaf id)."""
    cols = slice(6 * arity, 7 * arity)
    codes = nodes[:, cols].view(np.int32)
    internal = codes >= 0
    codes[internal] += node_off
    codes[~internal] = leaf_map(-codes[~internal] - 1)
    nodes[:, cols] = codes.view(np.float32)


def _world_boxes(roots, flat: FlatScene, meta: SceneMeta) -> np.ndarray:
    """World box (I, 6) of each instance: its mesh's root box (the union
    of the binary root row's two child boxes; roots[mesh], a numpy row)
    through the instance transform, by the box's 8 corners."""
    inst_tf = flat.inst_transform.cpu().numpy()
    out = np.zeros((meta.num_instances, 6), np.float32)
    for i, mesh_id in enumerate(meta.inst_mesh):
        root = roots[mesh_id]
        lo = np.minimum(root[0:3], root[6:9])
        hi = np.maximum(root[3:6], root[9:12])
        # a one-leaf binary tree fills slot 0 only (slot 1 is +-inf)
        lo = np.where(np.isfinite(lo), lo, np.minimum(root[0:3], root[3:6]))
        hi = np.where(np.isfinite(hi), hi, np.maximum(root[0:3], root[3:6]))
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
            np.float32,
        )
        m = inst_tf[i]
        wc = corners @ m[:3, :3].T + m[:3, 3]
        out[i, 0:3] = wc.min(axis=0)
        out[i, 3:6] = wc.max(axis=0)
    return out


def build_unified_set(flat: FlatScene, meta: SceneMeta) -> UnifiedPair:
    """The two-level tables of a multi-instance scene (the role of the
    reference's TopLevelBVH, embree_utils.cpp:121-136).

    A native SAH BLAS per mesh, with its prim ids made global, and a native
    SAH TLAS over the instances' world boxes, built as degenerate "box
    triangles" (v0 = lo, e1 = hi - lo, e2 = 0) one to a leaf. For each
    arity the tables fuse into one node table (every BLAS, then the TLAS
    from row tlas_lo) and one leaf table (every triangle leaf, then one
    instance-entry row per instance), with every child code rebased into
    the fused numbering; unpadded. The stack bound is the TLAS's plus the
    deepest BLAS's plus 2. Leaf size and wide arity as in build_blas_set;
    the TLAS keeps one instance to a leaf. Raises if the native builder is
    unavailable."""
    v0, e1, e2 = host_triangles(flat)
    inst_inv = flat.inst_inv.cpu().numpy()
    dev = flat.shade_rows.device
    L, wide = native_leaf_size(), wide_arity()
    I = meta.num_instances

    # per mesh: (nodes2, nodes_wide, leaf rows with global prim ids, depth2, stack_wide)
    parts = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        nodes2, nodes4, leaf_rows, depth2, stack4 = _native_build(v0[sl], e1[sl], e2[sl], L, wide)
        leaf_rows = leaf_rows.copy()
        ids = leaf_rows[:, 9 * L : 10 * L].view(np.int32)
        ids[ids >= 0] += start
        parts.append((nodes2, nodes4, leaf_rows, depth2, stack4))
    leaf_off = np.cumsum([0] + [p[2].shape[0] for p in parts])
    n_tri_leaves = int(leaf_off[-1])

    inst_aabb = _world_boxes([p[0][0] for p in parts], flat, meta)
    # instance-entry rows; the prim slots hold -1 so that Moller-Trumbore
    # can never report a hit on one
    ent = np.zeros((I, 10 * L), np.float32)
    ent[:, 9 * L : 10 * L].view(np.int32)[:] = -1
    ent[:, 0:12] = inst_inv[:, :3, :].reshape(I, 12)
    ent[:, 13] = np.arange(I, dtype=np.int32).view(np.float32)

    tnodes2, tnodes4, tleaf, tdepth2, tstack4 = _native_build(
        inst_aabb[:, 0:3], inst_aabb[:, 3:6] - inst_aabb[:, 0:3], np.zeros((I, 3), np.float32), 1,
        wide,
    )
    tleaf_inst = tleaf[:, 9].view(np.int32)  # TLAS leaf -> instance id

    out = {}
    for arity, sel, tnodes, tstack in ((2, 0, tnodes2.copy(), tdepth2),
                                       (wide, 1, tnodes4.copy(), tstack4)):
        tables, node_off, off = [], [], 0
        for mi, part in enumerate(parts):
            tbl = part[sel].copy()
            _rebase_codes(tbl, arity, off, lambda leaf, base=int(leaf_off[mi]): -(leaf + base) - 1)
            tables.append(tbl)
            node_off.append(off)
            off += tbl.shape[0]
        tlas_lo = off
        # TLAS internals follow the BLAS rows; its leaves become entry rows
        _rebase_codes(tnodes, arity, tlas_lo, lambda leaf: -(n_tri_leaves + tleaf_inst[leaf]) - 1)
        ent_a = ent.copy()
        ent_a[:, 12] = np.asarray([node_off[m] for m in meta.inst_mesh], np.int32).view(np.float32)
        blas_depth = max(p[3] if arity == 2 else p[4] for p in parts)
        out[arity] = UnifiedBvh(
            nodes=torch.as_tensor(np.concatenate(tables + [tnodes]), device=dev),
            leaf_rows=torch.as_tensor(np.concatenate([p[2] for p in parts] + [ent_a]), device=dev),
            n_tri_leaves=n_tri_leaves,
            tlas_lo=tlas_lo,
            stack_bound=int(tstack) + int(blas_depth) + 2,
        )
    return UnifiedPair(
        closest=out[2], any=out[wide], inst_aabb=torch.as_tensor(inst_aabb, device=dev)
    )


def compute_instance_aabbs(flat: FlatScene, meta: Optional[SceneMeta] = None) -> torch.Tensor:
    """World box (I, 6) of each instance: with the two-level tables, the
    boxes its TLAS was built over; with one BlasPair per mesh (the LBVH
    fallback), its mesh's root box through the instance transform
    (_world_boxes, which needs meta): the root box of an LBVH is its
    triangles' bounds, from which the JAX package computes the same boxes
    (chameleonrt_tpu/engine/trace_bvh.py compute_instance_aabbs)."""
    if flat.blas and isinstance(flat.blas[0], UnifiedPair):
        return flat.blas[0].inst_aabb
    if meta is None:
        raise ValueError("instance boxes over per-mesh tables need the scene's meta")
    roots = [pair.closest.nodes[0].cpu().numpy() for pair in flat.blas]
    return torch.as_tensor(_world_boxes(roots, flat, meta), device=flat.tri_v0.device)


def _instance_cull(flat: FlatScene, inst_id: int, orig, dir, t_min, t_max):
    """Lanes whose ray meets instance inst_id's world box within
    [t_min, t_max] (a slab test; a NaN from 0 * inf counts as an unbounded
    slab): the others skip that instance's walk."""
    box = flat.inst_aabb[inst_id]
    inv = 1.0 / dir
    entry, exit_ = t_min, t_max
    for a in range(3):
        t0 = (box[a] - orig[:, a]) * inv[:, a]
        t1 = (box[a + 3] - orig[:, a]) * inv[:, a]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        entry = torch.maximum(entry, torch.where(torch.isnan(lo), float("-inf"), lo))
        exit_ = torch.minimum(exit_, torch.where(torch.isnan(hi), float("inf"), hi))
    return entry <= exit_


def _instance_trace_fns(meta: SceneMeta, routes):
    """(trace_closest, trace_any) of a multi-instance scene over one table
    per mesh (the LBVH fallback): a loop over the instances, as the JAX
    engine's make_trace_fns unrolls it, each instance's walk one call of
    its mesh's flat route, routes[mesh] (choose_route), with the lanes
    whose ray misses the instance's world box (_instance_cull), or meets
    it past the nearest hit so far, masked off."""
    walks = {m: _walks(r, False) for m, r in routes.items()}

    def _object_rays(flat: FlatScene, inst_id: int, orig, dir):
        inv = flat.inst_inv[inst_id]
        return (transform_point(inv, orig).contiguous(),
                transform_vector(inv, dir).contiguous())

    def trace_closest(flat: FlatScene, orig, dir, t_min: float, active) -> Hit:
        """Closest hit from t_min over every instance; tri is the global
        triangle id and inst the hit instance. A lane that overflowed its
        stack in any instance is tri = -2 (it may have dropped subtrees),
        which the path tracer treats as a miss."""
        R = orig.shape[0]
        tmin = torch.full((R,), t_min, dtype=torch.float32, device=orig.device)
        best = Hit.none(R, orig.device)
        ovf = torch.zeros((R,), dtype=torch.bool, device=orig.device)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            start, count = meta.mesh_tri_ranges[mesh_id]
            if count == 0:
                continue
            inst_active = active & _instance_cull(flat, inst_id, orig, dir, tmin, best.t)
            o, d = _object_rays(flat, inst_id, orig, dir)
            t, prim, u, v = walks[mesh_id][0](
                getattr(flat.blas[mesh_id], routes[mesh_id].closest_table), o, d, tmin,
                inst_active, best.t)
            found = prim >= 0
            ovf |= prim == -2
            best = best.merge(Hit(
                t=torch.where(found, t, T_MAX),
                tri=torch.where(found, prim + start, -1).to(torch.int32),
                inst=torch.where(found, inst_id, -1).to(torch.int32),
                u=u,
                v=v,
            ))
        ok = active & ~ovf
        return Hit(
            t=torch.where(ok, best.t, T_MAX),
            tri=torch.where(ok, best.tri, torch.where(active & ovf, -2, -1)).to(torch.int32),
            inst=torch.where(ok, best.inst, -1).to(torch.int32),
            u=best.u,
            v=best.v,
        )

    def trace_any(flat: FlatScene, orig, dir, t_max, mask):
        """Occlusion along (EPSILON, t_max) by any instance."""
        R = orig.shape[0]
        tmin = torch.full((R,), EPSILON, dtype=torch.float32, device=orig.device)
        t_max = t_max.contiguous()
        occluded = torch.zeros((R,), dtype=torch.bool, device=orig.device)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            if meta.mesh_tri_ranges[mesh_id][1] == 0:
                continue
            inst_mask = mask & ~occluded & _instance_cull(flat, inst_id, orig, dir, tmin, t_max)
            o, d = _object_rays(flat, inst_id, orig, dir)
            occluded = occluded | walks[mesh_id][1](
                getattr(flat.blas[mesh_id], routes[mesh_id].any_table), o, d, tmin, t_max,
                inst_mask)
        return occluded & mask

    return trace_closest, trace_any


def _unified_trace_fns(route: Route):
    """(trace_closest, trace_any) over the two-level tables: one traversal
    for the whole scene on the route (choose_route), closest hit on the
    UnifiedPair's route.closest_table, any hit on its wide table."""
    closest_fn, any_fn = _walks(route, True)

    def trace_closest(flat: FlatScene, orig, dir, t_min: float, active) -> Hit:
        """Closest hit from t_min; tri is the global triangle id and inst
        the hit instance. A miss or inactive lane is (T_MAX, -1, -1); a
        stack overflow is tri = -2, which the path tracer treats as a miss."""
        R = orig.shape[0]
        tmin = torch.full((R,), t_min, dtype=torch.float32, device=orig.device)
        tmax = torch.full((R,), T_MAX, dtype=torch.float32, device=orig.device)
        t, prim, inst, u, v = closest_fn(
            getattr(flat.blas[0], route.closest_table), orig.contiguous(), dir.contiguous(), tmin,
            active, tmax
        )
        return Hit(t=t, tri=prim, inst=inst, u=u, v=v)

    def trace_any(flat: FlatScene, orig, dir, t_max, mask):
        """Occlusion along (EPSILON, t_max); shadow rays start at EPSILON."""
        R = orig.shape[0]
        tmin = torch.full((R,), EPSILON, dtype=torch.float32, device=orig.device)
        return any_fn(getattr(flat.blas[0], route.any_table), orig.contiguous(), dir.contiguous(),
                      tmin, t_max.contiguous(), mask.contiguous())

    return trace_closest, trace_any


def table_bytes(pbvh) -> int:
    """Bytes of a table's node and leaf rows (a PackedBvh or a
    UnifiedBvh)."""
    return pbvh.nodes.numel() * pbvh.nodes.element_size() + \
        pbvh.leaf_rows.numel() * pbvh.leaf_rows.element_size()


def blas_bytes(blas) -> int:
    """Bytes of a FlatScene's tables (its blas): the node and leaf rows of
    every BlasPair or UnifiedPair, a table the pair's two share (a
    BlasPair's leaf rows) counted once."""
    sizes = {}
    for pair in blas:
        for table in (pair.closest, pair.any):
            for rows in (table.nodes, table.leaf_rows):
                sizes[rows.data_ptr()] = rows.numel() * rows.element_size()
    return sum(sizes.values())


def streamed_tier(pbvh, l2_bytes: Optional[int] = None) -> bool:
    """The streamed tier's gate, the counterpart of the JAX package's
    slotlane_eligible / slotlane_stream_eligible (ops/traverse_slotlane.py):
    True where the node and leaf rows (of a flat PackedBvh or a two-level
    UnifiedBvh) exceed the L2 of the table's device, so that most
    row fetches go to HBM. l2_bytes, if given, stands for the L2's size; a
    table on the CPU has none and stays in the B1-B4 tier."""
    if l2_bytes is None:
        if pbvh.nodes.device.type != "cuda":
            return False
        l2_bytes = torch.cuda.get_device_properties(pbvh.nodes.device).L2_cache_size
    return table_bytes(pbvh) > l2_bytes


class Route(NamedTuple):
    """How a scene, or one mesh of it, is traced (choose_route): for each
    hit kind the KERNELS key of ops/traverse_cuda.py whose kernel walks it,
    or "plain" for the plain walk of ops/traverse.py, and which table of
    the pair ("closest": binary, "any": wide) it traces."""

    closest: str
    any: str
    closest_table: str
    any_table: str


TRAVERSALS = ("auto", "plain", "lane", "stream", "persistent", "packet")


def _off(var: str) -> bool:
    """Whether the environment switches var off, as the JAX package reads
    its switches: "0", "false" or "off"; unset keeps it on."""
    return os.environ.get(var) in ("0", "false", "off")


def choose_route(traversal: str, instances: int, two_level: bool, table=None,
                 l2_bytes: Optional[int] = None) -> Route:
    """The route of a scene of `instances` instances over flat tables (a
    flat scene's mesh, or one mesh of the LBVH fallback's multi-instance
    scene) or two-level ones (two_level), for traversal:

    ============  ==========================  ==============================
    traversal     flat tables                 two-level tables
    ============  ==========================  ==============================
    "auto"        B5a/B5b where               B5c/B5d where
                  streamed_tier(table), else  streamed_tier(table), else
                  B1/B2                       B3/B4
    "plain"       the plain walk              the plain walk
    "lane"        B1/B2                       B3/B4
    "stream"      B5a/B5b                     B5c/B5d
    "persistent"  B6a/B6b                     B6c/B6d
    "packet"      B7a/B7b, both on the        ValueError
                  binary table
    ============  ==========================  ==============================

    The environment, read here as the JAX package reads it:
    CHAMELEONRT_PACKET=0 ("false", "off") gives the plain walk whatever the
    value (over "packet"'s binary tables for "packet"), and
    CHAMELEONRT_SLOTLANE=0 gives "auto" B6a/B6b or B6c/B6d (the JAX
    package's work-queue kernels; on the card one kernel serves both of its
    stream values) without the gate; an explicit value is not moved by it.
    "packet" on a scene of more than one instance raises ValueError
    whatever the environment: the JAX package has no two-level grid
    kernel. Any hit traces the wide table; closest hit traces the binary
    table where closest_arity() is 2, else the wide one, as the JAX
    package's _closest_table chooses; "packet" traces both on the binary
    one, whatever closest_arity says (the JAX engine's route past both
    failed persistent VMEM gates, its trace_bvh.py:680-688, :871-879).

    table is the wide table the gate weighs (l2_bytes as in
    streamed_tier); "auto" with the kernels on raises without it."""
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be one of {', '.join(TRAVERSALS)}, got {traversal!r}")
    packet = traversal == "packet"
    if packet and instances > 1:
        raise ValueError("the packet traversal traces flat scenes only: there is no two-level "
                         f"grid-packet kernel, and this scene has {instances} instances")
    closest_table = "closest" if packet or closest_arity() == 2 else "any"
    any_table = "closest" if packet else "any"
    if traversal == "plain" or _off("CHAMELEONRT_PACKET"):
        return Route("plain", "plain", closest_table, any_table)
    if traversal == "auto":
        if _off("CHAMELEONRT_SLOTLANE"):
            traversal = "persistent"
        elif table is None:
            raise ValueError("the streamed tier's gate needs the scene's tables (blas)")
        else:
            traversal = "stream" if streamed_tier(table, l2_bytes) else "lane"
    return Route(traverse_cuda.kernel_for(traversal, "closest", two_level),
                 traverse_cuda.kernel_for(traversal, "any", two_level), closest_table, any_table)


def _walks(route: Route, two_level: bool):
    """(closest, any) walk functions of a route: the kernels' launchers
    bound to its keys, or the plain walks."""
    if route.closest == "plain":
        if two_level:
            return plain.traverse_closest_unified, plain.traverse_any_unified
        return plain.traverse_closest, plain.traverse_any
    return (lambda *args: traverse_cuda.launch_closest(route.closest, *args),
            lambda *args: traverse_cuda.launch_any(route.any, *args))


def _flat_trace_fns(meta: SceneMeta, route: Route, mesh_id: int):
    """(trace_closest, trace_any) of a flat scene: rays move into the one
    instance's object space and trace its mesh's tables on the route
    (choose_route)."""
    closest_fn, any_fn = _walks(route, False)
    start = meta.mesh_tri_ranges[mesh_id][0]

    def _object_rays(flat: FlatScene, orig, dir):
        inv = flat.inst_inv[0]
        return (
            transform_point(inv, orig).contiguous(),
            transform_vector(inv, dir).contiguous(),
        )

    def trace_closest(flat: FlatScene, orig, dir, t_min: float, active) -> Hit:
        """Closest hit from t_min. A miss or inactive lane is (T_MAX, -1);
        a lane whose traversal overflowed its stack is tri = -2 (it may have
        dropped subtrees), which the path tracer treats as a miss."""
        R = orig.shape[0]
        o, d = _object_rays(flat, orig, dir)
        tmin = torch.full((R,), t_min, dtype=torch.float32, device=orig.device)
        tmax = torch.full((R,), T_MAX, dtype=torch.float32, device=orig.device)
        t, prim, u, v = closest_fn(getattr(flat.blas[mesh_id], route.closest_table), o, d, tmin,
                                   active, tmax)
        found = prim >= 0
        zero = torch.zeros_like(u)
        return Hit(
            t=t,
            tri=torch.where(found, prim + start, prim),
            inst=torch.where(found, 0, -1).to(torch.int32),
            u=torch.where(found, u, zero),
            v=torch.where(found, v, zero),
        )

    def trace_any(flat: FlatScene, orig, dir, t_max, mask):
        """Occlusion along (EPSILON, t_max); shadow rays start at EPSILON."""
        R = orig.shape[0]
        o, d = _object_rays(flat, orig, dir)
        tmin = torch.full((R,), EPSILON, dtype=torch.float32, device=orig.device)
        return any_fn(getattr(flat.blas[mesh_id], route.any_table), o, d, tmin, t_max.contiguous(),
                      mask.contiguous())

    return trace_closest, trace_any


def make_trace_fns(meta: SceneMeta, traversal: str = "auto", blas=None):
    """(trace_closest, trace_any) for the scene on the traversal's route
    (choose_route, which states the routing rules): over the two-level
    tables of a multi-instance scene, or the one instanced mesh's tables
    of a flat scene. On CUDA tensors a kernel route launches its kernels;
    on CPU tensors every route runs the plain walk. blas, the FlatScene's
    tables, feeds the gate of "auto". A multi-instance scene over one
    table per mesh (the LBVH fallback's, known from blas) traces instance
    by instance (_instance_trace_fns), each instance through its mesh's
    flat route."""
    multi = meta.num_instances > 1
    if multi and blas is not None and not isinstance(blas[0], UnifiedPair):
        routes = {m: choose_route(traversal, meta.num_instances, False, blas[m].any)
                  for m in set(meta.inst_mesh)}
        return _instance_trace_fns(meta, routes)
    mesh_id = 0 if multi else meta.inst_mesh[0]
    route = choose_route(traversal, meta.num_instances, multi,
                         None if blas is None else blas[mesh_id].any)
    if multi:
        return _unified_trace_fns(route)
    return _flat_trace_fns(meta, route, mesh_id)
