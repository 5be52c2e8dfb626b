"""BVH tables and flat scene traversal (torch): the counterpart of the flat
branch of chameleonrt_tpu/engine/trace_bvh.py.

Each mesh gets one native binned-SAH build (native/bvhbuilder.cpp, built
with make at first use by chameleonrt_tpu/native.py), which emits a binary
table and a BVH4 table over shared leaf rows, unpadded.
Rays are moved into the instance's object space and traverse the BVH4
table for both closest and any hit, through kernels B1 and B2 on the card
(ops/traverse_cuda.py) or their plain versions (ops/traverse.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from chameleonrt_tpu import native
from chameleonrt_tpu_torch.engine.device_scene import (
    BlasPair,
    FlatScene,
    PackedBvh,
    SceneMeta,
    host_triangles,
)
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.ops.intersect import T_MAX, Hit
from chameleonrt_tpu_torch.ops.math import EPSILON, transform_point, transform_vector

LEAF_SIZE = 4  # triangles per leaf row (the JAX package's default)
WIDE_ARITY = 4  # children per wide row


def build_blas_set(flat: FlatScene, meta: SceneMeta) -> Tuple[BlasPair, ...]:
    """One BlasPair per mesh; leaf prim ids are local to the mesh's range.
    Raises if the native SAH builder is unavailable."""
    if meta.num_instances > 1:
        raise NotImplementedError(
            "instanced scenes need the two-level (TLAS+BLAS) path, which is not ported yet"
        )
    if native.get_lib() is None:
        raise RuntimeError("the native SAH builder (native/, built with make) is unavailable")
    v0, e1, e2 = host_triangles(flat)
    dev = flat.shade_rows.device
    blas = []
    for start, count in meta.mesh_tri_ranges:
        sl = slice(start, start + count)
        res = native.build_bvh_pair_native(v0[sl], e1[sl], e2[sl], LEAF_SIZE, wide_arity=WIDE_ARITY)
        if res is None:
            raise RuntimeError(f"native SAH build of {count} triangles returned no tables")
        nodes2, nodes4, leaf_rows, depth2, stack4 = res
        leaf = torch.as_tensor(leaf_rows, device=dev)
        blas.append(
            BlasPair(
                closest=PackedBvh(torch.as_tensor(nodes2, device=dev), leaf, depth2),
                any=PackedBvh(torch.as_tensor(nodes4, device=dev), leaf, stack4),
            )
        )
    return tuple(blas)


def make_trace_fns(meta: SceneMeta, use_kernels: bool = True):
    """(trace_closest, trace_any) for a single-instance scene, on the BVH4
    table of the instanced mesh. use_kernels=False runs the plain traversal
    on any device (the card's parity checks use it); otherwise CUDA tensors
    go through kernels B1 and B2."""
    if meta.num_instances != 1:
        raise NotImplementedError("only single-instance (flat) scenes are ported")
    closest_fn = traverse_cuda.traverse_closest if use_kernels else plain.traverse_closest
    any_fn = traverse_cuda.traverse_any if use_kernels else plain.traverse_any
    mesh_id = meta.inst_mesh[0]
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
