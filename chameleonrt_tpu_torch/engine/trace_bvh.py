"""BVH tables and scene traversal (torch): the counterpart of
chameleonrt_tpu/engine/trace_bvh.py.

Each mesh gets one native binned-SAH build (native/bvhbuilder.cpp,
compiled at first use by chameleonrt_tpu_torch/native.py), which emits a
binary table and a BVH4 table over shared leaf rows, unpadded.

- A single-instance (flat) scene keeps one BlasPair per mesh: rays move
  into the instance's object space and traverse the BVH4 table, through
  kernels B1 and B2 on the card, or B5a and B5b where the table exceeds
  the card's L2 (streamed_tier).
- A multi-instance scene fuses every mesh's BLAS and a TLAS over the
  instances' world boxes into one UnifiedPair, and one launch traces the
  whole two-level scene, through kernels B3 and B4 on the card, or B5c
  and B5d where the two-level table exceeds the card's L2.

The kernels' wrappers are in ops/traverse_cuda.py, their plain versions in
ops/traverse.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.ops.intersect import T_MAX, Hit
from chameleonrt_tpu_torch.ops.math import EPSILON, transform_point, transform_vector

LEAF_SIZE = 4  # triangles per leaf row (the JAX package's default)
WIDE_ARITY = 4  # children per wide row


def _native_build(v0, e1, e2, leaf_size: int = LEAF_SIZE):
    """One native SAH build: (nodes2, nodes4, leaf_rows, depth2, stack4).
    Raises if the native builder is unavailable."""
    if native.get_lib() is None:
        raise RuntimeError("the native SAH builder (native/) is unavailable: no C++ compiler")
    res = native.build_bvh_pair_native(v0, e1, e2, leaf_size, wide_arity=WIDE_ARITY)
    if res is None:
        raise RuntimeError(f"native SAH build of {len(v0)} triangles returned no tables")
    return res


def build_blas_set(flat: FlatScene, meta: SceneMeta) -> Tuple:
    """The scene's BVH tables: (UnifiedPair,) for a multi-instance scene,
    otherwise one BlasPair per mesh with leaf prim ids local to the mesh's
    range. Raises if the native SAH builder is unavailable."""
    if meta.num_instances > 1:
        return (build_unified_set(flat, meta),)
    v0, e1, e2 = host_triangles(flat)
    dev = flat.shade_rows.device
    blas = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        nodes2, nodes4, leaf_rows, depth2, stack4 = _native_build(v0[sl], e1[sl], e2[sl])
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


def _instance_boxes(parts, flat: FlatScene, meta: SceneMeta) -> np.ndarray:
    """World box (I, 6) of each instance: its mesh's BLAS root box (the
    union of the binary root's two child boxes) through the instance
    transform, by the box's 8 corners."""
    inst_tf = flat.inst_transform.cpu().numpy()
    out = np.zeros((meta.num_instances, 6), np.float32)
    for i, mesh_id in enumerate(meta.inst_mesh):
        root = parts[mesh_id][0][0]
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
    deepest BLAS's plus 2. Raises if the native builder is unavailable."""
    v0, e1, e2 = host_triangles(flat)
    inst_inv = flat.inst_inv.cpu().numpy()
    dev = flat.shade_rows.device
    L = LEAF_SIZE
    I = meta.num_instances

    # per mesh: (nodes2, nodes4, leaf rows with global prim ids, depth2, stack4)
    parts = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        nodes2, nodes4, leaf_rows, depth2, stack4 = _native_build(v0[sl], e1[sl], e2[sl])
        leaf_rows = leaf_rows.copy()
        ids = leaf_rows[:, 9 * L : 10 * L].view(np.int32)
        ids[ids >= 0] += start
        parts.append((nodes2, nodes4, leaf_rows, depth2, stack4))
    leaf_off = np.cumsum([0] + [p[2].shape[0] for p in parts])
    n_tri_leaves = int(leaf_off[-1])

    inst_aabb = _instance_boxes(parts, flat, meta)
    # instance-entry rows; the prim slots hold -1 so that Moller-Trumbore
    # can never report a hit on one
    ent = np.zeros((I, 10 * L), np.float32)
    ent[:, 9 * L : 10 * L].view(np.int32)[:] = -1
    ent[:, 0:12] = inst_inv[:, :3, :].reshape(I, 12)
    ent[:, 13] = np.arange(I, dtype=np.int32).view(np.float32)

    tnodes2, tnodes4, tleaf, tdepth2, tstack4 = _native_build(
        inst_aabb[:, 0:3], inst_aabb[:, 3:6] - inst_aabb[:, 0:3], np.zeros((I, 3), np.float32), 1
    )
    tleaf_inst = tleaf[:, 9].view(np.int32)  # TLAS leaf -> instance id

    out = {}
    for arity, sel, tnodes, tstack in ((2, 0, tnodes2.copy(), tdepth2),
                                       (WIDE_ARITY, 1, tnodes4.copy(), tstack4)):
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
        closest=out[2], any=out[WIDE_ARITY], inst_aabb=torch.as_tensor(inst_aabb, device=dev)
    )


def compute_instance_aabbs(flat: FlatScene) -> torch.Tensor:
    """World box (I, 6) of each instance of a multi-instance scene: the
    boxes its TLAS was built over."""
    if not (flat.blas and isinstance(flat.blas[0], UnifiedPair)):
        raise ValueError("instance boxes come with the two-level tables of a multi-instance scene")
    return flat.blas[0].inst_aabb


def _unified_trace_fns(use_kernels: bool, stream: bool):
    """(trace_closest, trace_any) over the two-level BVH4 table: one
    traversal for the whole scene, through B3 and B4 on the card, or B5c
    and B5d of the streamed tier where stream is True; the plain two-level
    traversal where use_kernels is False."""
    if not use_kernels:
        closest_fn, any_fn = plain.traverse_closest_unified, plain.traverse_any_unified
    elif stream:
        closest_fn = traverse_cuda.traverse_closest_unified_stream
        any_fn = traverse_cuda.traverse_any_unified_stream
    else:
        closest_fn, any_fn = traverse_cuda.traverse_closest_unified, traverse_cuda.traverse_any_unified

    def trace_closest(flat: FlatScene, orig, dir, t_min: float, active) -> Hit:
        """Closest hit from t_min; tri is the global triangle id and inst
        the hit instance. A miss or inactive lane is (T_MAX, -1, -1); a
        stack overflow is tri = -2, which the path tracer treats as a miss."""
        R = orig.shape[0]
        tmin = torch.full((R,), t_min, dtype=torch.float32, device=orig.device)
        tmax = torch.full((R,), T_MAX, dtype=torch.float32, device=orig.device)
        t, prim, inst, u, v = closest_fn(
            flat.blas[0].any, orig.contiguous(), dir.contiguous(), tmin, active, tmax
        )
        return Hit(t=t, tri=prim, inst=inst, u=u, v=v)

    def trace_any(flat: FlatScene, orig, dir, t_max, mask):
        """Occlusion along (EPSILON, t_max); shadow rays start at EPSILON."""
        R = orig.shape[0]
        tmin = torch.full((R,), EPSILON, dtype=torch.float32, device=orig.device)
        return any_fn(flat.blas[0].any, orig.contiguous(), dir.contiguous(), tmin,
                      t_max.contiguous(), mask.contiguous())

    return trace_closest, trace_any


def table_bytes(pbvh) -> int:
    """Bytes of a table's node and leaf rows (a PackedBvh or a
    UnifiedBvh)."""
    return pbvh.nodes.numel() * pbvh.nodes.element_size() + \
        pbvh.leaf_rows.numel() * pbvh.leaf_rows.element_size()


def streamed_tier(pbvh, l2_bytes: Optional[int] = None) -> bool:
    """The streamed tier's gate, the counterpart of the JAX package's
    slotlane_eligible / slotlane_stream_eligible (ops/traverse_slotlane.py):
    True where the BVH4 node and leaf rows (of a flat PackedBvh or a
    two-level UnifiedBvh) exceed the L2 of the table's device, so that most
    row fetches go to HBM. l2_bytes, if given, stands for the L2's size; a
    table on the CPU has none and stays in the B1-B4 tier."""
    if l2_bytes is None:
        if pbvh.nodes.device.type != "cuda":
            return False
        l2_bytes = torch.cuda.get_device_properties(pbvh.nodes.device).L2_cache_size
    return table_bytes(pbvh) > l2_bytes


def make_trace_fns(meta: SceneMeta, use_kernels: bool = True, stream: Optional[bool] = None,
                   blas=None, l2_bytes: Optional[int] = None):
    """(trace_closest, trace_any) for the scene, both on BVH4 tables:
    the two-level table of a multi-instance scene, or the one instanced
    mesh's table of a flat scene. use_kernels=False runs the plain
    traversal on any device (the card's parity checks use it); otherwise
    CUDA tensors go through the kernels: for a flat scene B1 and B2, or B5a
    and B5b of the streamed tier where stream is True; for a multi-instance
    scene B3 and B4, or B5c and B5d where stream is True. stream=None
    decides by streamed_tier on the scene's BVH4 table (blas, the
    FlatScene's; l2_bytes as there)."""
    multi = meta.num_instances > 1
    mesh_id = 0 if multi else meta.inst_mesh[0]
    if use_kernels and stream is None:
        if blas is None:
            raise ValueError("the streamed tier's gate needs the scene's tables (blas)")
        stream = streamed_tier(blas[mesh_id].any, l2_bytes)
    if multi:
        return _unified_trace_fns(use_kernels, bool(stream))
    start = meta.mesh_tri_ranges[mesh_id][0]
    if not use_kernels:
        closest_fn, any_fn = plain.traverse_closest, plain.traverse_any
    elif stream:
        closest_fn, any_fn = traverse_cuda.traverse_closest_stream, traverse_cuda.traverse_any_stream
    else:
        closest_fn, any_fn = traverse_cuda.traverse_closest, traverse_cuda.traverse_any

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
        t, prim, u, v = closest_fn(flat.blas[mesh_id].any, o, d, tmin, active, tmax)
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
        return any_fn(flat.blas[mesh_id].any, o, d, tmin, t_max.contiguous(), mask.contiguous())

    return trace_closest, trace_any
