"""Scene tables from the JAX package, as the port's tensors.

from_jax takes the JAX package's FlatScene and BlasPair tables already
converted to numpy arrays (for example with jax.tree.map(np.asarray, ...))
and its SceneMeta, and returns the port's FlatScene and SceneMeta on
``device``. Tests use it so that both packages trace the very same tables.
Nothing here imports jax: the inputs are read by attribute name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chameleonrt_tpu_torch.engine.device_scene import BlasPair, FlatScene, PackedBvh, SceneMeta
from chameleonrt_tpu_torch.ops.lights import LightArrays
from chameleonrt_tpu_torch.ops.texture import TextureAtlas


def _t(a, device):
    return torch.as_tensor(np.array(a), device=device)  # a copy: the inputs may be read-only


def _bvh(p, device) -> PackedBvh:
    return PackedBvh(_t(p.nodes, device), _t(p.leaf_rows, device), int(p.max_depth))


def from_jax(flat_np, meta, blas_np, device):
    """(FlatScene, SceneMeta) of the port from the JAX package's tables.
    blas_np is a sequence of BlasPair(closest, any) of PackedBvh with numpy
    arrays and a certified max_depth (the native builder's tables)."""
    blas = tuple(BlasPair(_bvh(b.closest, device), _bvh(b.any, device)) for b in blas_np)
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
