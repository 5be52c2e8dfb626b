"""CRTS loader — ChameleonRT's Blender-export binary format
(reference util/scene.cpp:417-624): a u64 little-endian JSON-header size,
the JSON header, then a binary blob addressed by buffer views.

Header layout (reference behavior):
- ``meshes``: one geometry per mesh; ``positions``/``indices``/``texcoords``
  are buffer-view ids (dtype strings per util/gltf_types.cpp:144+).
- ``images``: encoded image bytes in a view (decoded vertically flipped,
  scene.cpp:497-500); ``color_space`` "SRGB"/"LINEAR".
- ``materials``: full Disney parameters; each float param may carry
  ``<name>_texture`` = {texture, channel}; base_color_texture is a bare id.
- ``objects``: typed MESH (mesh+material -> deduped ParameterizedMesh,
  scene.cpp:560-582) / LIGHT (quad from the object matrix columns) / CAMERA
  (fov_y divided by Blender-match factor 1.18, scene.cpp:603).
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Dict, Tuple

import numpy as np

from chameleonrt_tpu_torch.scene.texture_mask import make_texture_handle
from chameleonrt_tpu_torch.scene.types import (
    Camera,
    ColorSpace,
    DisneyMaterial,
    Geometry,
    Image,
    Instance,
    MaterialMode,
    Mesh,
    ParameterizedMesh,
    QuadLight,
    Scene,
    default_obj_light,
)

_DTYPES = {
    "INT_8": (np.int8, 1),
    "UINT_8": (np.uint8, 1),
    "INT_16": (np.int16, 1),
    "UINT_16": (np.uint16, 1),
    "INT_32": (np.int32, 1),
    "UINT_32": (np.uint32, 1),
    "FLOAT_32": (np.float32, 1),
    "FLOAT_64": (np.float64, 1),
}
_BASE_NAMES = {
    "INT_8": "I8",
    "UINT_8": "U8",
    "INT_16": "I16",
    "UINT_16": "U16",
    "INT_32": "I32",
    "UINT_32": "U32",
    "FLOAT_32": "F32",
    "FLOAT_64": "F64",
}
for _n, _b in _BASE_NAMES.items():
    _dt = _DTYPES[_n][0]
    for vec, cnt in (("VEC2", 2), ("VEC3", 3), ("VEC4", 4), ("MAT2", 4), ("MAT3", 9), ("MAT4", 16)):
        _DTYPES[f"{vec}_{_b}"] = (_dt, cnt)


def _read_view(blob: memoryview, view: dict) -> np.ndarray:
    dtype, ncomp = _DTYPES[view["type"]]
    off = view["byte_offset"]
    length = view["byte_length"]
    arr = np.frombuffer(blob, dtype, length // np.dtype(dtype).itemsize, off)
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)
    return arr


def load_crts(path: str, material_mode: MaterialMode = MaterialMode.DEFAULT) -> Scene:
    print(f"Loading CRTS {path}")
    # mmap stands in for the reference's FileMapping (util/file_mapping.h)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if data.size < 8:
        raise ValueError(f"{path}: truncated CRTS file (no header size)")
    (header_size,) = struct.unpack_from("<Q", data[:8].tobytes())
    if 8 + header_size > data.size:
        raise ValueError(
            f"{path}: truncated CRTS file (header claims {header_size} bytes, "
            f"file has {data.size - 8})"
        )
    header = json.loads(data[8 : 8 + header_size].tobytes().decode("utf-8"))
    blob = memoryview(data[8 + header_size :])
    views = header.get("buffer_views", [])

    scene = Scene(material_mode=material_mode)

    for m in header.get("meshes", []):
        verts = _read_view(blob, views[m["positions"]]).astype(np.float32)
        idx = _read_view(blob, views[m["indices"]]).astype(np.uint32)
        uvs = None
        if "texcoords" in m:
            uvs = _read_view(blob, views[m["texcoords"]]).astype(np.float32)
        scene.meshes.append(
            Mesh(geometries=[Geometry(vertices=verts, indices=idx, uvs=uvs)])
        )

    for img in header.get("images", []):
        raw = _read_view(blob, views[img["view"]]).tobytes()
        # decode via the image IO dispatch (PNG native; flip vertically like
        # the reference's stbi_set_flip_vertically_on_load, scene.cpp:497)
        from chameleonrt_tpu_torch.utils.image_io import read_image_or_placeholder

        suffix = ".png" if raw[:8] == b"\x89PNG\r\n\x1a\n" else ".img"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
            tf.write(raw)
            name = tf.name
        try:
            pixels = read_image_or_placeholder(name)[::-1]
        finally:
            os.unlink(name)
        cs = ColorSpace.LINEAR if img.get("color_space") == "LINEAR" else ColorSpace.SRGB
        scene.textures.append(
            Image(name=img.get("name", ""), data=np.ascontiguousarray(pixels), color_space=cs)
        )

    if material_mode == MaterialMode.DEFAULT:
        for m in header.get("materials", []):
            mat = DisneyMaterial()
            mat.base_color = np.asarray(m["base_color"][:3], np.float32)
            if "base_color_texture" in m:
                mat.set_color_texture(int(m["base_color_texture"]))

            def fparam(name, crts_name=None):
                key = crts_name or name
                val = float(m.get(key, 0.0))
                tex = m.get(key + "_texture")
                if tex is not None:
                    val = make_texture_handle(int(tex["texture"]), int(tex["channel"]))
                return val

            mat.metallic = fparam("metallic")
            mat.specular = fparam("specular")
            mat.roughness = fparam("roughness")
            mat.specular_tint = fparam("specular_tint")
            mat.anisotropy = fparam("anisotropy", "anisotropic")
            mat.sheen = fparam("sheen")
            mat.sheen_tint = fparam("sheen_tint")
            mat.clearcoat = fparam("clearcoat")
            mat.clearcoat_gloss = fparam("clearcoat_gloss", "clearcoat_roughness")
            mat.ior = fparam("ior")
            mat.specular_transmission = fparam("specular_transmission", "transmission")
            scene.materials.append(mat)

    # Objects: MESH instances (deduped pmesh by (mesh, material)), quad
    # LIGHTs and CAMERAs straight from the matrix columns.
    pmesh_ids: Dict[Tuple[int, int], int] = {}
    for n in header.get("objects", []):
        typ = n["type"]
        matrix = np.asarray(n["matrix"], np.float32).reshape(4, 4).T  # column-major
        if typ == "MESH":
            mesh_id = int(n["mesh"])
            mat_id = int(n["material"]) if material_mode == MaterialMode.DEFAULT else -1
            key = (mesh_id, mat_id)
            if key not in pmesh_ids:
                pmesh_ids[key] = len(scene.parameterized_meshes)
                scene.parameterized_meshes.append(
                    ParameterizedMesh(mesh_id, [mat_id])
                )
            scene.instances.append(Instance(matrix, pmesh_ids[key]))
        elif typ == "LIGHT":
            color = np.asarray(n["color"][:3], np.float32)
            z = matrix[:3, 2]
            scene.lights.append(
                QuadLight(
                    emission=color * float(n["energy"]),
                    position=matrix[:3, 3],
                    normal=-z / np.linalg.norm(z),
                    v_x=matrix[:3, 0] / np.linalg.norm(matrix[:3, 0]),
                    v_y=matrix[:3, 1] / np.linalg.norm(matrix[:3, 1]),
                    width=float(n["size"][0]),
                    height=float(n["size"][1]),
                )
            )
        elif typ == "CAMERA":
            pos = matrix[:3, 3]
            dir = -matrix[:3, 2]
            dir = dir / np.linalg.norm(dir)
            up = matrix[:3, 1] / np.linalg.norm(matrix[:3, 1])
            scene.cameras.append(
                Camera(
                    position=pos,
                    center=pos + dir * 10.0,
                    up=up,
                    # Blender-match factor (reference scene.cpp:601-603)
                    fov_y=float(n["fov_y"]) / 1.18,
                )
            )
        else:
            raise ValueError(f"Unsupported object type: {typ}")

    scene.validate_materials()
    if not scene.lights:
        print("No lights found in scene, generating one")
        light = default_obj_light()
        light.emission = np.full(3, 10.0, np.float32)
        scene.lights = [light]
    return scene
