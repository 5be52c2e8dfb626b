"""Scene tables from the JAX package, as the port's tensors.

from_jax takes the JAX package's FlatScene and BVH tables already
converted to numpy arrays (for example with jax.tree.map(np.asarray, ...))
and its SceneMeta, and returns the port's FlatScene and SceneMeta on
``device``. Tests use it so that both packages trace the very same tables.
Nothing here imports jax: the inputs are read by attribute name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chameleonrt_tpu_torch.engine.device_scene import (
    BlasPair,
    FlatScene,
    PackedBvh,
    SceneMeta,
    UnifiedBvh,
    UnifiedPair,
)
from chameleonrt_tpu_torch.ops.lights import LightArrays
from chameleonrt_tpu_torch.ops.texture import TextureAtlas


def _t(a, device):
    return torch.as_tensor(np.array(a), device=device)  # a copy: the inputs may be read-only


def _bvh(p, device) -> PackedBvh:
    return PackedBvh(_t(p.nodes, device), _t(p.leaf_rows, device), int(p.max_depth))


def _unified(u, device) -> UnifiedBvh:
    return UnifiedBvh(_t(u.nodes, device), _t(u.leaf_rows, device), int(u.n_tri_leaves),
                      int(u.tlas_lo), int(u.stack_bound))


def _pair(b, device):
    if hasattr(b, "inst_aabb"):  # a UnifiedPair
        return UnifiedPair(_unified(b.closest, device), _unified(b.any, device),
                           _t(b.inst_aabb, device))
    return BlasPair(_bvh(b.closest, device), _bvh(b.any, device))


def from_jax(flat_np, meta, blas_np, device):
    """(FlatScene, SceneMeta) of the port from the JAX package's tables.
    blas_np is a sequence of BlasPair(closest, any) of PackedBvh with numpy
    arrays and a certified max_depth, or one UnifiedPair(closest, any,
    inst_aabb) of UnifiedBvh with a certified stack_bound (the native
    builder's tables). The JAX package pads the unified tables with rows
    that no child code reaches; they come across as they are."""
    blas = tuple(_pair(b, device) for b in blas_np)
    flat = FlatScene(
        tri_v0=_t(flat_np.tri_v0, device),
        tri_e1=_t(flat_np.tri_e1, device),
        tri_e2=_t(flat_np.tri_e2, device),
        shade_rows=_t(flat_np.shade_rows, device),
        mat_rows=_t(flat_np.mat_rows, device),
        inst_transform=_t(flat_np.inst_transform, device),
        inst_inv=_t(flat_np.inst_inv, device),
        inst_mat_table=_t(flat_np.inst_mat_table, device),
        lights=LightArrays(*(_t(f, device) for f in flat_np.lights)),
        atlas=TextureAtlas(atlas=_t(flat_np.atlas.atlas, device), table=_t(flat_np.atlas.table, device)),
        blas=blas,
    )
    fields = {f.name for f in dataclasses.fields(SceneMeta)}
    port_meta = SceneMeta(**{k: v for k, v in dataclasses.asdict(meta).items() if k in fields})
    return flat, port_meta
