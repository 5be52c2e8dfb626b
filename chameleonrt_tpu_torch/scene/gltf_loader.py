"""glTF 2.0 / GLB loader (hand-rolled JSON + binary parsing, numpy).

Behavioral equivalent of the reference's tinygltf path
(reference util/scene.cpp:230-415): a glTF "mesh" becomes a
ParameterizedMesh (glTF fuses geometry + material), primitives become
Geometries (POSITION + TEXCOORD_0 + u16/u32 indices; triangles only; vertex
normals deliberately unused — shading uses geometric normals), the node
hierarchy is flattened to single-level instances (util/flatten_gltf.h:10-15),
pbrMetallicRoughness maps to Disney (baseColor -> base_color [SRGB texture],
metallic <- blue channel, roughness <- green channel of the
metallicRoughness texture, scene.cpp:352-389), and a default quad light is
generated (scene.cpp:406-414).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

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
    Scene,
    default_obj_light,
)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


def _load_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    pos = 12
    gltf_json = None
    bin_chunk = b""
    while pos < len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        payload = data[pos + 8 : pos + 8 + clen]
        pos += 8 + clen
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(payload.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = payload
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


def _load_buffers(doc: dict, base_dir: str, bin_chunk: bytes) -> List[bytes]:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc: dict, buffers: List[bytes], accessor_id: int) -> np.ndarray:
    """Read an accessor into an (N, C) numpy array, honoring bufferView
    strides (the reference's Accessor<T>, util/buffer_view.h:9-46)."""
    acc = doc["accessors"][accessor_id]
    count = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" not in acc:
        return np.zeros((count, ncomp), dtype)
    bv = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[bv["buffer"]]
    offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or itemsize
    if stride == itemsize:
        arr = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
    else:
        raw = np.frombuffer(buf, np.uint8, stride * (count - 1) + itemsize, offset)
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, itemsize), strides=(stride, 1)
        )
        arr = np.ascontiguousarray(strided).view(dtype).reshape(count, ncomp)
    return np.ascontiguousarray(arr)


def _node_transform(node: dict) -> np.ndarray:
    """Node-local transform: matrix, or T*R*S composition
    (reference util/gltf_types.cpp read_node_transform)."""
    if "matrix" in node:
        # glTF matrices are column-major
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], np.float32))
    if "rotation" in node:
        x, y, z, w = [float(v) for v in node["rotation"]]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m[:3, :3] = rot @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float32)
    return m


def _decode_image(doc: dict, buffers: List[bytes], img_def: dict, base_dir: str) -> np.ndarray:
    """Decode a glTF image (bufferView-embedded, data URI, or external
    file). PNG decoded natively; unsupported codecs get a placeholder."""
    from chameleonrt_tpu_torch.utils import png as png_codec
    from chameleonrt_tpu_torch.utils.image_io import read_image_or_placeholder

    raw: Optional[bytes] = None
    if "bufferView" in img_def:
        bv = doc["bufferViews"][img_def["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = bytes(buffers[bv["buffer"]][off : off + bv["byteLength"]])
    elif "uri" in img_def:
        uri = img_def["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            return read_image_or_placeholder(os.path.join(base_dir, uri))
    if raw is not None and raw[:8] == b"\x89PNG\r\n\x1a\n":
        import io
        import tempfile

        # the PNG codec reads paths; decode from bytes via temp file
        with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as tf:
            tf.write(raw)
            name = tf.name
        try:
            return png_codec.read_png(name)
        finally:
            os.unlink(name)
    print(
        f"Warning: unsupported glTF image codec for '{img_def.get('name', '?')}'; "
        "using placeholder"
    )
    tex = np.zeros((4, 4, 3), np.uint8)
    tex[:, :, 0] = 255
    tex[:, :, 2] = 255
    return tex


def load_gltf(path: str, material_mode: MaterialMode = MaterialMode.DEFAULT) -> Scene:
    print(f"Loading GLTF {path}")
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        doc, bin_chunk = _load_glb(path)
    else:
        with open(path, "r") as f:
            doc = json.load(f)
        bin_chunk = b""
    buffers = _load_buffers(doc, base_dir, bin_chunk)

    scene = Scene(material_mode=material_mode)

    # Meshes: glTF mesh -> ParameterizedMesh + Mesh (1:1), primitives ->
    # Geometries (scene.cpp:259-327)
    for m in doc.get("meshes", []):
        mesh = Mesh()
        material_ids: List[int] = []
        for p in m.get("primitives", []):
            if p.get("mode", 4) != 4:
                raise ValueError(
                    "Unsupported primitive mode! Only triangles are supported"
                )
            if material_mode == MaterialMode.DEFAULT:
                material_ids.append(p.get("material", -1))
            else:
                material_ids.append(-1)
            attrs = p["attributes"]
            verts = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            uvs = None
            if "TEXCOORD_0" in attrs:
                uvs = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32
                )
            if "indices" in p:
                comp = doc["accessors"][p["indices"]]["componentType"]
                if comp not in (5123, 5125, 5121):
                    raise ValueError("Unsupported index component type")
                idx = _read_accessor(doc, buffers, p["indices"]).reshape(-1)
            else:
                idx = np.arange(len(verts), dtype=np.uint32)
            idx = idx.astype(np.uint32).reshape(-1, 3)
            mesh.geometries.append(Geometry(vertices=verts, indices=idx, uvs=uvs))
        scene.parameterized_meshes.append(
            ParameterizedMesh(len(scene.meshes), material_ids)
        )
        scene.meshes.append(mesh)

    if material_mode == MaterialMode.DEFAULT:
        # Images (color space refined below, scene.cpp:333-351)
        color_spaces: Dict[int, ColorSpace] = {}
        for img_def in doc.get("images", []):
            data = _decode_image(doc, buffers, img_def, base_dir)
            scene.textures.append(
                Image(
                    name=img_def.get("name", f"image{len(scene.textures)}"),
                    data=data,
                    color_space=ColorSpace.LINEAR,
                )
            )

        def tex_source(tex_index: int) -> int:
            return doc["textures"][tex_index].get("source", 0)

        # Materials: pbrMetallicRoughness -> Disney (scene.cpp:352-389)
        for m in doc.get("materials", []):
            pbr = m.get("pbrMetallicRoughness", {})
            mat = DisneyMaterial()
            factor = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
            mat.base_color = np.asarray(factor[:3], np.float32)
            mat.metallic = float(pbr.get("metallicFactor", 1.0))
            mat.roughness = float(pbr.get("roughnessFactor", 1.0))
            if "baseColorTexture" in pbr:
                tid = tex_source(pbr["baseColorTexture"]["index"])
                scene.textures[tid].color_space = ColorSpace.SRGB
                mat.set_color_texture(tid)
            if "metallicRoughnessTexture" in pbr:
                from chameleonrt_tpu_torch.scene.texture_mask import make_texture_handle

                tid = tex_source(pbr["metallicRoughnessTexture"]["index"])
                scene.textures[tid].color_space = ColorSpace.LINEAR
                # glTF: metallic = blue channel, roughness = green channel
                mat.metallic = make_texture_handle(tid, 2)
                mat.roughness = make_texture_handle(tid, 1)
            scene.materials.append(mat)

    # Flatten the node hierarchy into single-level instances
    # (flatten_gltf equivalent, scene.cpp:392-400)
    default_scene = doc.get("scene", 0)
    scenes = doc.get("scenes", [{}])
    root_nodes = scenes[default_scene].get("nodes", [])
    nodes = doc.get("nodes", [])

    def walk(node_id: int, parent: np.ndarray):
        node = nodes[node_id]
        xform = parent @ _node_transform(node)
        if "mesh" in node:
            scene.instances.append(Instance(xform, node["mesh"]))
        if "camera" in node and node["camera"] < len(doc.get("cameras", [])):
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                pos = xform[:3, 3]
                fwd = -xform[:3, 2]
                up = xform[:3, 1]
                fov = np.degrees(cam["perspective"].get("yfov", 1.0))
                scene.cameras.append(
                    Camera(position=pos, center=pos + fwd, up=up, fov_y=float(fov))
                )
        for child in node.get("children", []):
            walk(child, xform)

    for nid in root_nodes:
        walk(nid, np.eye(4, dtype=np.float32))

    scene.validate_materials()

    print("Generating light for GLTF scene")
    scene.lights = [default_obj_light()]
    return scene
