"""Wavefront OBJ + MTL loader.

Behavioral equivalent of the reference's tinyobjloader path
(reference util/scene.cpp:94-228): shapes become one Geometry each with
per-(v,vn,vt)-triple vertex remapping, one material per shape (per-face
materials unsupported, warning printed), MTL -> Disney conversion, diffuse
texture handles, and a generated quad light since OBJ has no lights.

A native C++ fast path (chameleonrt_tpu_torch.native) is used for large files when
available; this module is the portable fallback and the semantics oracle.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chameleonrt_tpu_torch.scene.types import (
    ColorSpace,
    DisneyMaterial,
    Geometry,
    Image,
    Instance,
    MaterialMode,
    Mesh,
    ParameterizedMesh,
    Scene,
    default_obj_light,
)
from chameleonrt_tpu_torch.utils.image_io import read_image_or_placeholder


def _parse_mtl(path: str) -> "list[tuple[str, dict]]":
    """Parse an MTL file into an ordered list of (name, properties)."""
    materials: List[Tuple[str, dict]] = []
    cur: Optional[dict] = None
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        print(f"Warning: cannot open MTL file {path}")
        return materials
    with fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = {}
                materials.append((" ".join(parts[1:]), cur))
            elif cur is None:
                continue
            elif key in ("Kd", "Ks", "Ke", "Ka"):
                cur[key] = [float(x) for x in parts[1:4]]
            elif key in ("Ns", "d", "Ni"):
                cur[key] = float(parts[1])
            elif key in ("map_Kd",):
                cur[key] = " ".join(parts[1:])
    return materials


def _mtl_to_disney(props: dict) -> DisneyMaterial:
    """MTL -> Disney conversion (reference util/scene.cpp:188-214):
    base_color = Kd, specular = clamp(Ns/500, 0, 1),
    roughness = clamp(1 - specular, 0, 1), transmission disabled."""
    mat = DisneyMaterial()
    kd = props.get("Kd")
    if kd is not None:
        mat.base_color = np.asarray(kd, dtype=np.float32)
    ns = float(props.get("Ns", 0.0))
    mat.specular = float(np.clip(ns / 500.0, 0.0, 1.0))
    mat.roughness = float(np.clip(1.0 - mat.specular, 0.0, 1.0))
    mat.specular_transmission = 0.0
    return mat


def _resolve_index(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices count from the end."""
    return idx - 1 if idx > 0 else count + idx


def load_obj(
    path: str,
    material_mode: MaterialMode = MaterialMode.DEFAULT,
    use_native: bool = True,
) -> Scene:
    """Load an OBJ scene. Uses the native C++ parser
    (chameleonrt_tpu_torch.native) when available, falling back to the pure-Python
    scanner below; both produce identical scenes (tested against each
    other)."""
    if use_native:
        try:
            from chameleonrt_tpu_torch import native

            parsed = native.parse_obj_native(path)
        except Exception as e:  # noqa: BLE001
            print(f"Native OBJ parser failed ({e}); using Python fallback")
            parsed = None
        if parsed is not None:
            return _assemble_native(path, parsed, material_mode)
    return _load_obj_python(path, material_mode)


def _assemble_native(path, parsed, material_mode: MaterialMode) -> Scene:
    shapes, mtllibs = parsed
    base_dir = os.path.dirname(os.path.abspath(path))
    scene = Scene(material_mode=material_mode)

    mtl_materials: List[Tuple[str, dict]] = []
    mtl_name_to_id: Dict[str, int] = {}
    for mtl_file in mtllibs:
        for name, props in _parse_mtl(os.path.join(base_dir, mtl_file)):
            if name not in mtl_name_to_id:
                mtl_name_to_id[name] = len(mtl_materials)
                mtl_materials.append((name, props))

    mesh = Mesh()
    material_ids: List[int] = []
    for s in shapes:
        if len(s.indices) == 0:
            continue
        mesh.geometries.append(
            Geometry(
                vertices=s.vertices,
                indices=s.indices,
                normals=s.normals,
                uvs=s.uvs,
            )
        )
        if material_mode == MaterialMode.DEFAULT:
            material_ids.append(mtl_name_to_id.get(s.material, -1))
            if s.mixed_materials:
                print(
                    "Warning: per-face material IDs are not supported, materials "
                    "may look wrong. Please reexport your mesh with each material "
                    "group as an OBJ group"
                )
        else:
            material_ids.append(-1)

    scene.meshes = [mesh]
    scene.parameterized_meshes = [ParameterizedMesh(0, material_ids)]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]
    _assemble_materials(scene, mtl_materials, base_dir, material_mode)
    scene.validate_materials()
    print("Generating light for OBJ scene")
    scene.lights = [default_obj_light()]
    return scene


def _assemble_materials(scene, mtl_materials, base_dir, material_mode):
    """MTL -> Disney materials + diffuse texture handles
    (reference util/scene.cpp:188-214)."""
    if material_mode != MaterialMode.DEFAULT:
        return
    texture_ids: Dict[str, int] = {}
    for _name, props in mtl_materials:
        mat = _mtl_to_disney(props)
        tex_name = props.get("map_Kd")
        if tex_name:
            if tex_name not in texture_ids:
                texture_ids[tex_name] = len(scene.textures)
                tex_path = os.path.join(base_dir, tex_name.replace("\\", "/"))
                scene.textures.append(
                    Image(
                        name=tex_name,
                        data=read_image_or_placeholder(tex_path),
                        color_space=ColorSpace.SRGB,
                    )
                )
            mat.set_color_texture(texture_ids[tex_name])
        scene.materials.append(mat)


def _load_obj_python(path: str, material_mode: MaterialMode) -> Scene:
    scene = Scene(material_mode=material_mode)
    base_dir = os.path.dirname(os.path.abspath(path))

    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []

    mtl_materials: List[Tuple[str, dict]] = []
    mtl_name_to_id: Dict[str, int] = {}
    cur_material = -1

    # Per-shape accumulation state (a shape = an `o`/`g` group, mirroring
    # tinyobj's shape splitting used by the reference loader).
    shapes: List[dict] = []

    def new_shape():
        shapes.append(
            {
                "remap": {},
                "verts": [],
                "norms": [],
                "uvs": [],
                "tris": [],
                "face_mats": [],
            }
        )

    new_shape()

    def shape_vertex(shape: dict, trip: Tuple[int, int, int]) -> int:
        fnd = shape["remap"].get(trip)
        if fnd is not None:
            return fnd
        vid = len(shape["verts"])
        shape["remap"][trip] = vid
        shape["verts"].append(positions[trip[0]])
        if trip[1] >= 0:
            n = normals[trip[1]]
            ln = (n[0] * n[0] + n[1] * n[1] + n[2] * n[2]) ** 0.5 or 1.0
            shape["norms"].append((n[0] / ln, n[1] / ln, n[2] / ln))
        if trip[2] >= 0:
            shape["uvs"].append(uvs[trip[2]])
        return vid

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] in "#\n\r":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                uvs.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
            elif tag == "f":
                shape = shapes[-1]
                corner_trips = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = _resolve_index(int(comps[0]), len(positions))
                    ti = (
                        _resolve_index(int(comps[1]), len(uvs))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        _resolve_index(int(comps[2]), len(normals))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    corner_trips.append((vi, ni, ti))
                # triangulate as a fan (tinyobj triangulate=true equivalent)
                for k in range(1, len(corner_trips) - 1):
                    tri = (
                        shape_vertex(shape, corner_trips[0]),
                        shape_vertex(shape, corner_trips[k]),
                        shape_vertex(shape, corner_trips[k + 1]),
                    )
                    shape["tris"].append(tri)
                    shape["face_mats"].append(cur_material)
            elif tag in ("o", "g"):
                if shapes[-1]["tris"]:
                    new_shape()
            elif tag == "usemtl":
                name = " ".join(parts[1:])
                cur_material = mtl_name_to_id.get(name, -1)
            elif tag == "mtllib":
                for mtl_file in parts[1:]:
                    mats = _parse_mtl(os.path.join(base_dir, mtl_file))
                    for name, props in mats:
                        mtl_name_to_id[name] = len(mtl_materials)
                        mtl_materials.append((name, props))

    mesh = Mesh()
    material_ids: List[int] = []
    for shape in shapes:
        if not shape["tris"]:
            continue
        nverts = len(shape["verts"])
        geom = Geometry(
            vertices=np.asarray(shape["verts"], np.float32).reshape(nverts, 3),
            indices=np.asarray(shape["tris"], np.uint32).reshape(-1, 3),
            normals=np.asarray(shape["norms"], np.float32)
            if len(shape["norms"]) == nverts
            else None,
            uvs=np.asarray(shape["uvs"], np.float32)
            if len(shape["uvs"]) == nverts
            else None,
        )
        mesh.geometries.append(geom)
        # One material per shape: first face's material, with a warning if
        # they differ (reference util/scene.cpp:126-139).
        fmats = shape["face_mats"]
        if material_mode == MaterialMode.DEFAULT:
            material_ids.append(fmats[0])
            if len(set(fmats)) > 1:
                print(
                    "Warning: per-face material IDs are not supported, materials "
                    "may look wrong. Please reexport your mesh with each material "
                    "group as an OBJ group"
                )
        else:
            material_ids.append(-1)

    scene.meshes = [mesh]
    scene.parameterized_meshes = [ParameterizedMesh(0, material_ids)]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]

    _assemble_materials(scene, mtl_materials, base_dir, material_mode)
    scene.validate_materials()

    # OBJ has no lights: generate one (reference util/scene.cpp:218-227)
    print("Generating light for OBJ scene")
    scene.lights = [default_obj_light()]
    return scene
