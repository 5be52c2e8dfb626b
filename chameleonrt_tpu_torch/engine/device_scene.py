"""Scene -> device tensors (torch): the counterpart of
chameleonrt_tpu/engine/device_scene.py, with the BVH table types of
chameleonrt_tpu/ops/lbvh.py.

The scene flattens into per-triangle (v0, e1, e2), one fused (T, 32) shade
row per triangle, a packed material table whose float slots may carry
texture handles, per-instance transforms and material tables, a quad-light
table and one texture atlas of bilinear quad rows. SceneMeta is the static
structure the render loop specializes on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from chameleonrt_tpu_torch.ops.bsdf import MaterialBatch
from chameleonrt_tpu_torch.ops.lights import LightArrays
from chameleonrt_tpu_torch.ops.texture import (
    TextureAtlas,
    build_quad_rows,
    textured_color_param,
    textured_scalar_param,
)
from chameleonrt_tpu_torch.scene.types import (
    ColorSpace,
    DisneyMaterial,
    MaterialMode,
    Scene,
    default_obj_light,
)

# MaterialBatch scalar fields in packed-row order (cols 3..13)
_SCALAR_FIELDS = MaterialBatch._fields[1:]


class PackedBvh(NamedTuple):
    """A packed BVH table (layout of chameleonrt_tpu/ops/lbvh.py PackedBvh):
    ``nodes`` (n, 8*arity) f32 with child c's AABB at cols [6c, 6c+6) and
    child codes bitcast at cols [6*arity, 7*arity) (code < 0 is leaf
    -(leaf+1)); ``leaf_rows`` (n_leaves, 10*L) f32, component-major
    v0 / e1 / e2 / prim. ``max_depth`` is the builder's certified stack
    need."""

    nodes: torch.Tensor
    leaf_rows: torch.Tensor
    max_depth: int

    @property
    def arity(self) -> int:
        return self.nodes.shape[1] // 8

    @property
    def num_leaves(self) -> int:
        return self.leaf_rows.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.leaf_rows.shape[1] // 10


class BlasPair(NamedTuple):
    """Binary (closest) and wide (any) tables of one SAH build; they share
    the leaf rows."""

    closest: PackedBvh
    any: PackedBvh


class UnifiedBvh(NamedTuple):
    """Two-level table of a multi-instance scene (layout of
    chameleonrt_tpu/ops/lbvh.py UnifiedBvh): every mesh's BLAS rows, then
    the TLAS rows from row ``tlas_lo`` on, in one node table. ``leaf_rows``
    holds every BLAS triangle leaf (prim ids global), then one instance
    entry row per instance from leaf ``n_tri_leaves`` on: cols [0, 12) the
    world-to-object 3x4 matrix row-major, col 12 the instance's BLAS root
    row and col 13 its instance id (both bitcast int32), prim slots -1.
    ``stack_bound`` is the certified stack need (TLAS + BLAS + 2)."""

    nodes: torch.Tensor
    leaf_rows: torch.Tensor
    n_tri_leaves: int
    tlas_lo: int
    stack_bound: int

    @property
    def arity(self) -> int:
        return self.nodes.shape[1] // 8

    @property
    def leaf_size(self) -> int:
        return self.leaf_rows.shape[1] // 10


class UnifiedPair(NamedTuple):
    """Binary (closest) and BVH4 (any) unified tables of one scene, and the
    instances' world boxes (I, 6) that the TLAS was built over."""

    closest: UnifiedBvh
    any: UnifiedBvh
    inst_aabb: torch.Tensor


class FlatScene(NamedTuple):
    """Device-resident scene."""

    tri_v0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    # (T, 32): [e1 xyz, e2 xyz, uv0, uv1, uv2, geom_slot (bits),
    #  mat_id (bits, single-instance scenes), pad, pad, packed material
    #  record (14 floats, single-instance scenes), pad, pad]
    shade_rows: torch.Tensor
    mat_rows: torch.Tensor  # (M, 16): 14 material floats + 2 pad
    inst_transform: torch.Tensor  # (I, 4, 4)
    inst_inv: torch.Tensor  # (I, 4, 4) world-to-object
    inst_mat_table: torch.Tensor  # (I, G_max) int32
    lights: LightArrays
    atlas: TextureAtlas
    # one BlasPair per mesh (single-instance scenes, and every scene of a
    # host with no native builder), or (UnifiedPair,)
    blas: Tuple[Union[BlasPair, UnifiedPair], ...] = ()
    # (I, 6) world box of each instance of a multi-instance scene over
    # per-mesh tables, which the instance loop culls by (engine/trace_bvh.py
    # compute_instance_aabbs); None otherwise
    inst_aabb: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class SceneMeta:
    """Static scene structure."""

    mesh_tri_ranges: Tuple[Tuple[int, int], ...]  # (start, count) per mesh
    inst_mesh: Tuple[int, ...]  # mesh id per instance
    num_lights: int
    num_tris: int
    num_instances: int
    has_textures: bool = False
    # which of the 12 material fields (base_color + 11 scalars) carry a
    # texture handle anywhere in the scene; () = unknown, fetch all
    textured_fields: Tuple[bool, ...] = ()


def _host_tables(scene: Scene):
    """Flatten the scene on the host. Returns a dict of numpy arrays plus
    the SceneMeta."""
    if not scene.meshes or scene.total_tris() == 0 or not scene.instances:
        raise ValueError("scene has no renderable geometry (no meshes/instances/triangles)")
    scene.validate_materials()

    v0s, e1s, e2s, uv0s, uv1s, uv2s, geom_slots = [], [], [], [], [], [], []
    mesh_ranges = []
    start = 0
    for mesh in scene.meshes:
        count = 0
        for gi, geom in enumerate(mesh.geometries):
            idx = geom.indices.astype(np.int64)
            v = geom.vertices
            a, b, c = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
            v0s.append(a)
            e1s.append(b - a)
            e2s.append(c - a)
            if geom.uvs is not None:
                uv = geom.uvs
                uv0s.append(uv[idx[:, 0]])
                uv1s.append(uv[idx[:, 1]])
                uv2s.append(uv[idx[:, 2]])
            else:
                z = np.zeros((len(idx), 2), np.float32)
                uv0s.append(z)
                uv1s.append(z)
                uv2s.append(z)
            geom_slots.append(np.full(len(idx), gi, np.int32))
            count += len(idx)
        mesh_ranges.append((start, count))
        start += count
    num_tris = start

    def cat(parts):
        return np.ascontiguousarray(np.concatenate(parts), dtype=np.float32)

    t = dict(tri_v0=cat(v0s), tri_e1=cat(e1s), tri_e2=cat(e2s))
    tri_geom_slot = np.concatenate(geom_slots).astype(np.int32)

    n_inst = len(scene.instances)
    g_max = max((len(m.geometries) for m in scene.meshes), default=1)
    inst_transform = np.zeros((n_inst, 4, 4), np.float32)
    inst_inv = np.zeros((n_inst, 4, 4), np.float32)
    inst_mat_table = np.zeros((n_inst, g_max), np.int32)
    inst_mesh = []
    for i, inst in enumerate(scene.instances):
        pm = scene.parameterized_meshes[inst.parameterized_mesh_id]
        inst_mesh.append(pm.mesh_id)
        inst_transform[i] = inst.transform
        inst_inv[i] = np.linalg.inv(inst.transform)
        inst_mat_table[i, : len(pm.material_ids)] = np.asarray(pm.material_ids, np.int32)

    mats = scene.materials if scene.materials else [DisneyMaterial()]
    packed = np.zeros((len(mats), 14), np.float32)
    for i, m in enumerate(mats):
        packed[i] = m.pack()
    mat_rows = np.zeros((len(mats), 16), np.float32)
    mat_rows[:, :14] = packed

    shade_rows = np.zeros((num_tris, 32), np.float32)
    shade_rows[:, 0:3] = t["tri_e1"]
    shade_rows[:, 3:6] = t["tri_e2"]
    shade_rows[:, 6:8] = cat(uv0s)
    shade_rows[:, 8:10] = cat(uv1s)
    shade_rows[:, 10:12] = cat(uv2s)
    shade_rows[:, 12] = tri_geom_slot.view(np.float32)
    if n_inst == 1:
        tri_mat = inst_mat_table[0][tri_geom_slot]
        shade_rows[:, 13] = tri_mat.astype(np.int32).view(np.float32)
        shade_rows[:, 16:30] = packed[tri_mat]

    has_textures = bool(scene.textures) and scene.material_mode != MaterialMode.WHITE_DIFFUSE
    atlas = table = None
    if has_textures:
        # one group of quad rows per texture shape, in first-seen order
        # (the JAX package's atlas order)
        table = np.zeros((len(scene.textures), 4), np.int32)
        groups: dict = {}
        for ti, img in enumerate(scene.textures):
            h, w, c = img.data.shape
            rgba = np.full((h, w, 4), 255, np.uint8)
            if c == 1:
                rgba[..., 0:3] = img.data
            elif c == 2:
                rgba[..., 0:3] = img.data[..., 0:1]
                rgba[..., 3] = img.data[..., 1]
            else:
                rgba[..., :c] = img.data
            groups.setdefault((h, w), []).append((ti, rgba))
        quads = []
        off = 0
        for (h, w), items in groups.items():
            for j, (ti, rgba) in enumerate(items):
                quads.append(build_quad_rows(rgba))
                srgb = scene.textures[ti].color_space == ColorSpace.SRGB
                table[ti] = (off + j * h * w, w, h, 1 if srgb else 0)
            off += len(items) * h * w
        atlas = np.concatenate(quads)

    t.update(
        shade_rows=shade_rows,
        mat_rows=mat_rows,
        inst_transform=inst_transform,
        inst_inv=inst_inv,
        inst_mat_table=inst_mat_table,
        atlas=atlas,
        atlas_table=table,
    )
    meta = SceneMeta(
        mesh_tri_ranges=tuple(mesh_ranges),
        inst_mesh=tuple(inst_mesh),
        num_lights=len(scene.lights),
        num_tris=num_tris,
        num_instances=n_inst,
        has_textures=has_textures,
        textured_fields=tuple(
            bool((packed[:, c].view(np.uint32) & np.uint32(0x80000000)).any())
            for c in (0, *range(3, 14))
        ),
    )
    return t, meta


def check_scene(scene) -> None:
    """Raise TypeError unless scene is the port's own Scene. A Scene of
    another package (the JAX package's loaders, for one) carries enums that
    compare unequal to the port's, so its sRGB textures would silently
    decode as linear."""
    if not isinstance(scene, Scene):
        raise TypeError(
            f"expected a {Scene.__module__}.Scene (from chameleonrt_tpu_torch.scene.loader), "
            f"got {type(scene).__module__}.{type(scene).__name__}"
        )


def build_device_scene(scene: Scene, device) -> Tuple[FlatScene, SceneMeta]:
    """Flatten the scene and upload it to ``device``. The BVH tables
    (``blas``) are added by engine.trace_bvh.build_blas_set. Raises
    TypeError on a Scene that is not the port's own class."""
    check_scene(scene)
    if not scene.lights:
        scene.lights = [default_obj_light()]
    t, meta = _host_tables(scene)

    def up(a):
        return torch.as_tensor(a, device=device)

    if t["atlas"] is not None:
        atlas = TextureAtlas(atlas=up(t["atlas"]), table=up(t["atlas_table"]))
    else:
        atlas = TextureAtlas.empty(device)
    flat = FlatScene(
        tri_v0=up(t["tri_v0"]),
        tri_e1=up(t["tri_e1"]),
        tri_e2=up(t["tri_e2"]),
        shade_rows=up(t["shade_rows"]),
        mat_rows=up(t["mat_rows"]),
        inst_transform=up(t["inst_transform"]),
        inst_inv=up(t["inst_inv"]),
        inst_mat_table=up(t["inst_mat_table"]),
        lights=LightArrays.from_scene_lights(scene.lights, device),
        atlas=atlas,
    )
    return flat, meta


def unpack_material(flat: FlatScene, meta: SceneMeta, mat_id, uv) -> MaterialBatch:
    """Per-lane material by id from the packed material table (multi-
    instance scenes, whose shade rows carry no material)."""
    row = flat.mat_rows[torch.clamp(mat_id, 0, flat.mat_rows.shape[0] - 1).long()]
    return unpack_material_row(flat, meta, row, uv)


def unpack_material_row(flat: FlatScene, meta: SceneMeta, row, uv) -> MaterialBatch:
    """Per-lane material from its packed record (R, >=14), with texture
    handles resolved (render_embree.ispc:79-103). Texture decode is skipped
    for fields no material of the scene textures."""
    base_color = row[:, 0:3]
    fields = {name: row[:, 3 + i] for i, name in enumerate(_SCALAR_FIELDS)}
    if not meta.has_textures:
        return MaterialBatch(base_color=base_color, **fields)
    tf = meta.textured_fields or (True,) * 12
    atlas = flat.atlas
    return MaterialBatch(
        base_color=textured_color_param(atlas, base_color, uv) if tf[0] else base_color,
        **{
            k: textured_scalar_param(atlas, v, uv) if tf[1 + i] else v
            for i, (k, v) in enumerate(fields.items())
        },
    )


def host_triangles(flat: FlatScene) -> Tuple[np.ndarray, ...]:
    """(v0, e1, e2) as host numpy arrays, for the host-side BVH build."""
    return tuple(x.detach().cpu().numpy() for x in (flat.tri_v0, flat.tri_e1, flat.tri_e2))
