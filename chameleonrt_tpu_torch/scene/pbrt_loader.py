"""PBRT v3 scene loader (hand-rolled parser, numpy).

Behavioral equivalent of the reference's pbrt-parser path
(reference util/scene.cpp:626-933, behind CHAMELEONRT_PBRT_SUPPORT):
the scene graph is flattened to single-level instances (makeSingleLevel,
scene.cpp:642); PBRT objects become parameterized meshes with per-shape
materials; material conversion follows scene.cpp:817-894 (disney -> direct
mapping with specular=0; plastic -> Kd + specular=luminance(Ks); matte -> Kd;
substrate -> Kd + specular/clearcoat from luminance(Ks)); imagemap textures
become base-color handles; unsupported material types warn and fall back to
the default material (material id -1, scene.cpp:893).

Parser scope: the directive set the ChameleonRT scenes exercise —
LookAt/Camera, Translate/Rotate/Scale/Transform/ConcatTransform,
Attribute/Transform/Object blocks with a graphics-state stack,
MakeNamedMaterial/NamedMaterial/Material, Texture (imagemap/constant),
AreaLightSource "diffuse", Shape trianglemesh/plymesh (binary+ascii PLY),
Include. Other directives parse and are ignored.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
    QuadLight,
    Scene,
    default_obj_light,
)
from chameleonrt_tpu_torch.utils.image_io import read_image_or_placeholder
from chameleonrt_tpu_torch.utils.util import luminance


# ---------------------------------------------------------------- tokenizer
_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"#]+|#[^\n]*')


def _tokenize(text: str):
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        if tok.startswith("#"):
            continue
        yield tok


class _TokenStream:
    def __init__(self, tokens):
        self.toks = list(tokens)
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def done(self) -> bool:
        return self.pos >= len(self.toks)


def _parse_params(ts: _TokenStream) -> Dict[str, Tuple[str, list]]:
    """Parse trailing `"type name" [values...]` parameter lists."""
    params = {}
    while True:
        tok = ts.peek()
        if tok is None or not tok.startswith('"'):
            break
        decl = ts.next().strip('"')
        parts = decl.split()
        ptype, pname = (parts[0], parts[1]) if len(parts) == 2 else ("string", parts[0])
        values = []
        if ts.peek() == "[":
            ts.next()
            while ts.peek() != "]":
                values.append(ts.next())
            ts.next()
        else:
            values.append(ts.next())
        values = [v.strip('"') if v.startswith('"') else v for v in values]
        if ptype in ("float", "rgb", "color", "point", "point3", "normal", "vector",
                     "spectrum", "blackbody", "point2", "xyz"):
            values = [float(v) for v in values]
        elif ptype == "integer":
            values = [int(float(v)) for v in values]
        elif ptype == "bool":
            values = [v == "true" for v in values]
        params[pname] = (ptype, values)
    return params


def _pval(params, name, default=None):
    if name in params:
        v = params[name][1]
        return v[0] if len(v) == 1 else v
    return default


# ------------------------------------------------------------------- PLY
def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Minimal PLY reader (ascii + binary_little_endian): returns
    (vertices (V,3), indices (T,3), uvs (V,2) or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(type, name)...])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    _SIZES = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
              "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
              "int": "i", "uint": "I", "int32": "i", "uint32": "I",
              "float": "f", "float32": "f", "double": "d", "float64": "d"}

    verts = None
    uvs = None
    faces = []
    if fmt == "ascii":
        values = body.decode("ascii", errors="replace").split()
        vp = 0
        for name, count, props in elements:
            if name == "vertex":
                ncomp = len(props)
                arr = np.array(values[vp : vp + count * ncomp], np.float32).reshape(count, ncomp)
                vp += count * ncomp
                names = [p[1] for p in props]
                verts = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
                if "u" in names and "v" in names:
                    uvs = arr[:, [names.index("u"), names.index("v")]]
                elif "s" in names and "t" in names:
                    uvs = arr[:, [names.index("s"), names.index("t")]]
            elif name == "face":
                for _ in range(count):
                    n = int(values[vp]); vp += 1
                    idx = [int(values[vp + k]) for k in range(n)]
                    vp += n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
    else:  # binary little endian
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = "<" + "".join(_SIZES[p[0]] for p in props)
                stride = struct.calcsize(fmt_str)
                raw = np.frombuffer(body, np.uint8, count * stride, pos).reshape(count, stride)
                pos += count * stride
                names = [p[1] for p in props]
                # assume homogeneous float32 vertex properties (the common case)
                if all(p[0] in ("float", "float32") for p in props):
                    arr = raw.reshape(-1).view(np.float32).reshape(count, len(props))
                    verts = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
                    if "u" in names and "v" in names:
                        uvs = arr[:, [names.index("u"), names.index("v")]]
                    elif "s" in names and "t" in names:
                        uvs = arr[:, [names.index("s"), names.index("t")]]
                else:
                    raise ValueError(f"{path}: mixed-type vertex properties unsupported")
            elif name == "face":
                lp = props[0]
                cnt_fmt = _SIZES[lp[1]]
                idx_fmt = _SIZES[lp[2]]
                cnt_size = struct.calcsize(cnt_fmt)
                idx_size = struct.calcsize(idx_fmt)
                for _ in range(count):
                    (n,) = struct.unpack_from("<" + cnt_fmt, body, pos)
                    pos += cnt_size
                    idx = struct.unpack_from(f"<{n}{idx_fmt}", body, pos)
                    pos += n * idx_size
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
    if verts is None:
        raise ValueError(f"{path}: PLY has no vertex element")
    return (
        np.ascontiguousarray(verts, np.float32),
        np.asarray(faces, np.uint32).reshape(-1, 3),
        np.ascontiguousarray(uvs, np.float32) if uvs is not None else None,
    )


# --------------------------------------------------------------- transforms
def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def _rotate(angle_deg, x, y, z):
    a = np.radians(angle_deg)
    axis = np.array([x, y, z], np.float64)
    axis /= np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R.astype(np.float32)
    return m


def _look_at(eye, look, up):
    """PBRT LookAt: camera-to-world transform."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    dir = look - eye
    dir /= np.linalg.norm(dir)
    right = np.cross(np.asarray(up) / np.linalg.norm(up), dir)
    right /= np.linalg.norm(right)
    new_up = np.cross(dir, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = dir
    m[:3, 3] = eye
    return m


# ------------------------------------------------------------------ loader
@dataclass
class _GState:
    ctm: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    material_id: int = -1
    area_light: Optional[np.ndarray] = None  # emission L
    reverse_orientation: bool = False

    def copy(self) -> "_GState":
        return _GState(self.ctm.copy(), self.material_id, None if self.area_light is None else self.area_light.copy(), self.reverse_orientation)


def load_pbrt(path: str, material_mode: MaterialMode = MaterialMode.DEFAULT) -> Scene:
    print(f"Loading PBRT {path}")
    base_dir = os.path.dirname(os.path.abspath(path))
    scene = Scene(material_mode=material_mode)

    texture_ids: Dict[str, int] = {}  # texture name -> texture index (or -1)
    named_materials: Dict[str, int] = {}
    tex_decls: Dict[str, dict] = {}

    def load_texture_file(fname: str) -> int:
        key = fname
        if key not in texture_ids:
            texture_ids[key] = len(scene.textures)
            scene.textures.append(
                Image(
                    name=os.path.basename(fname),
                    data=read_image_or_placeholder(os.path.join(base_dir, fname)),
                    color_space=ColorSpace.SRGB,
                )
            )
        return texture_ids[key]

    def convert_material(mtype: str, params) -> int:
        """PBRT material -> Disney (reference scene.cpp:817-894)."""
        mat = DisneyMaterial()

        def kd_or_texture(default=(0.5, 0.5, 0.5)):
            kd = _pval(params, "Kd")
            if isinstance(kd, str):  # texture reference
                decl = tex_decls.get(kd)
                if decl and decl["class"] == "imagemap":
                    mat.base_color = np.array([0.5, 0.5, 0.5], np.float32)
                    mat.set_color_texture(load_texture_file(decl["filename"]))
                elif decl and decl["class"] == "constant":
                    val = decl.get("value", [0.5, 0.5, 0.5])
                    mat.base_color = np.asarray(
                        val if isinstance(val, list) else [val] * 3, np.float32
                    )
                return
            if kd is not None:
                kdv = kd if isinstance(kd, list) else [kd] * 3
                mat.base_color = np.asarray(kdv, np.float32)
            else:
                mat.base_color = np.asarray(default, np.float32)

        if mtype == "disney":
            color = _pval(params, "color", [0.5, 0.5, 0.5])
            mat.base_color = np.asarray(
                color if isinstance(color, list) else [color] * 3, np.float32
            )
            mat.anisotropy = float(_pval(params, "anisotropic", 0.0))
            mat.clearcoat = float(_pval(params, "clearcoat", 0.0))
            mat.clearcoat_gloss = float(_pval(params, "clearcoatgloss", 1.0))
            mat.ior = float(_pval(params, "eta", 1.5))
            mat.metallic = float(_pval(params, "metallic", 0.0))
            mat.roughness = float(_pval(params, "roughness", 0.5))
            mat.sheen = float(_pval(params, "sheen", 0.0))
            mat.sheen_tint = float(_pval(params, "sheentint", 0.5))
            mat.specular_tint = float(_pval(params, "speculartint", 0.0))
            mat.specular = 0.0
        elif mtype == "plastic":
            kd_or_texture()
            ks = _pval(params, "Ks", [0.25, 0.25, 0.25])
            ks = ks if isinstance(ks, list) else [ks] * 3
            mat.specular = float(luminance(np.asarray(ks, np.float32)))
            mat.roughness = float(_pval(params, "roughness", 0.1))
        elif mtype == "matte":
            kd_or_texture()
        elif mtype == "substrate":
            kd_or_texture()
            ks = _pval(params, "Ks", [0.5, 0.5, 0.5])
            ks = ks if isinstance(ks, list) else [ks] * 3
            lum = float(luminance(np.asarray(ks, np.float32)))
            mat.specular = lum
            mat.roughness = 1.0
            mat.clearcoat = 1.0
            mat.clearcoat_gloss = lum
        else:
            print(f"Unsupported material type {mtype}")
            return -1
        mid = len(scene.materials)
        scene.materials.append(mat)
        return mid

    # object/instancing bookkeeping: pbrt Object -> ParameterizedMesh
    pmesh_of_object: Dict[str, int] = {}
    current_object: Optional[str] = None

    def add_shape(geom: Geometry, state: _GState):
        """Attach a shape: inside ObjectBegin it extends that object's mesh;
        at world level it becomes its own single-instance mesh."""
        if state.area_light is not None:
            _emit_area_light(geom, state)
            if material_mode == MaterialMode.DEFAULT and state.material_id < 0:
                pass  # lights can still be geometry with default material
        mat_id = state.material_id if material_mode == MaterialMode.DEFAULT else -1
        if current_object is not None:
            pm = scene.parameterized_meshes[pmesh_of_object[current_object]]
            scene.meshes[pm.mesh_id].geometries.append(geom)
            pm.material_ids.append(mat_id)
        else:
            mesh_id = len(scene.meshes)
            scene.meshes.append(Mesh(geometries=[geom]))
            scene.parameterized_meshes.append(ParameterizedMesh(mesh_id, [mat_id]))
            scene.instances.append(Instance(np.eye(4, dtype=np.float32), len(scene.parameterized_meshes) - 1))

    def _emit_area_light(geom: Geometry, state: _GState):
        """Approximate a diffuse area light as a QuadLight spanning the
        shape's principal plane (the reference renderer only supports quad
        lights, util/lights.h)."""
        verts = geom.vertices
        center = verts.mean(axis=0)
        # normal from the first triangle
        i0, i1, i2 = geom.indices[0]
        n = np.cross(verts[i1] - verts[i0], verts[i2] - verts[i0])
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0, -1, 0], np.float32)
        if state.reverse_orientation:
            n = -n
        from chameleonrt_tpu_torch.scene.types import ortho_basis

        v_x, v_y = ortho_basis(n.astype(np.float32))
        ext_x = float(np.abs((verts - center) @ v_x).max()) or 0.5
        ext_y = float(np.abs((verts - center) @ v_y).max()) or 0.5
        scene.lights.append(
            QuadLight(
                emission=np.asarray(state.area_light, np.float32),
                position=center - v_x * ext_x - v_y * ext_y,
                normal=n.astype(np.float32),
                v_x=v_x,
                v_y=v_y,
                width=2 * ext_x,
                height=2 * ext_y,
            )
        )

    def make_trianglemesh(params, ctm) -> Optional[Geometry]:
        P = np.asarray(_pval(params, "P", []), np.float32).reshape(-1, 3)
        idx = np.asarray(_pval(params, "indices", []), np.uint32).reshape(-1, 3)
        if len(P) == 0 or len(idx) == 0:
            return None
        uv = _pval(params, "uv") or _pval(params, "st")
        uvs = np.asarray(uv, np.float32).reshape(-1, 2) if uv is not None else None
        # bake the CTM into the vertices (shapes are world-level or
        # object-local; instances carry the instance CTM)
        Pw = P @ ctm[:3, :3].T + ctm[:3, 3]
        return Geometry(vertices=Pw, indices=idx, uvs=uvs)

    # ------------------------------------------------------------- parse
    def parse_file(fname: str, state_stack: List[_GState], in_world: List[bool]):
        nonlocal current_object
        with open(fname, "r", errors="replace") as f:
            ts = _TokenStream(_tokenize(f.read()))
        cam_to_world = None
        cam_fov = 65.0
        while not ts.done():
            tok = ts.next()
            st = state_stack[-1]
            if tok == "Include":
                inc = ts.next().strip('"')
                parse_file(os.path.join(base_dir, inc), state_stack, in_world)
            elif tok == "LookAt":
                vals = [float(ts.next()) for _ in range(9)]
                cam_to_world = _look_at(vals[0:3], vals[3:6], vals[6:9])
                st.ctm = st.ctm @ np.linalg.inv(cam_to_world).astype(np.float32)
            elif tok == "Camera":
                ctype = ts.next().strip('"')
                params = _parse_params(ts)
                if ctype == "perspective":
                    cam_fov = float(_pval(params, "fov", 65.0))
                if cam_to_world is not None:
                    pos = cam_to_world[:3, 3]
                    dir = cam_to_world[:3, 2]
                    up = cam_to_world[:3, 1]
                    scene.cameras.append(
                        Camera(position=pos, center=pos + dir * 10.0, up=up, fov_y=cam_fov)
                    )
            elif tok == "Translate":
                st.ctm = st.ctm @ _translate(*(float(ts.next()) for _ in range(3)))
            elif tok == "Scale":
                st.ctm = st.ctm @ _scale(*(float(ts.next()) for _ in range(3)))
            elif tok == "Rotate":
                st.ctm = st.ctm @ _rotate(*(float(ts.next()) for _ in range(4)))
            elif tok in ("Transform", "ConcatTransform"):
                if ts.peek() == "[":
                    ts.next()
                vals = []
                while ts.peek() != "]" and len(vals) < 16:
                    vals.append(float(ts.next()))
                if ts.peek() == "]":
                    ts.next()
                m = np.asarray(vals, np.float32).reshape(4, 4).T  # column-major
                st.ctm = m if tok == "Transform" else st.ctm @ m
            elif tok in ("WorldBegin",):
                in_world[0] = True
                state_stack[-1] = _GState()
            elif tok in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
                state_stack.append(st.copy())
                if tok == "ObjectBegin":
                    name = ts.next().strip('"')
                    current_object = name
                    if name not in pmesh_of_object:
                        mesh_id = len(scene.meshes)
                        scene.meshes.append(Mesh())
                        pmesh_of_object[name] = len(scene.parameterized_meshes)
                        scene.parameterized_meshes.append(ParameterizedMesh(mesh_id, []))
            elif tok in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
                state_stack.pop()
                if tok == "ObjectEnd":
                    current_object = None
            elif tok == "ObjectInstance":
                name = ts.next().strip('"')
                if name in pmesh_of_object:
                    scene.instances.append(Instance(st.ctm.copy(), pmesh_of_object[name]))
            elif tok == "ReverseOrientation":
                st.reverse_orientation = not st.reverse_orientation
            elif tok == "Texture":
                tname = ts.next().strip('"')
                _ttype = ts.next().strip('"')
                tclass = ts.next().strip('"')
                params = _parse_params(ts)
                tex_decls[tname] = {
                    "class": tclass,
                    "filename": _pval(params, "filename", ""),
                    "value": _pval(params, "value", [0.5, 0.5, 0.5]),
                }
            elif tok == "MakeNamedMaterial":
                name = ts.next().strip('"')
                params = _parse_params(ts)
                mtype = _pval(params, "type", "matte")
                named_materials[name] = (
                    convert_material(mtype, params)
                    if material_mode == MaterialMode.DEFAULT
                    else -1
                )
            elif tok == "NamedMaterial":
                name = ts.next().strip('"')
                st.material_id = named_materials.get(name, -1)
            elif tok == "Material":
                mtype = ts.next().strip('"')
                params = _parse_params(ts)
                st.material_id = (
                    convert_material(mtype, params)
                    if material_mode == MaterialMode.DEFAULT
                    else -1
                )
            elif tok == "AreaLightSource":
                ltype = ts.next().strip('"')
                params = _parse_params(ts)
                if ltype == "diffuse":
                    L = _pval(params, "L", [1.0, 1.0, 1.0])
                    st.area_light = np.asarray(
                        L if isinstance(L, list) else [L] * 3, np.float32
                    )
            elif tok == "LightSource":
                ts.next()
                _parse_params(ts)  # point/distant lights unsupported; parsed+skipped
            elif tok == "Shape":
                stype = ts.next().strip('"')
                params = _parse_params(ts)
                geom = None
                if stype == "trianglemesh":
                    geom = make_trianglemesh(params, st.ctm)
                elif stype == "plymesh":
                    fname = _pval(params, "filename", "")
                    try:
                        verts, idx, uvs = read_ply(os.path.join(base_dir, fname))
                        Pw = verts @ st.ctm[:3, :3].T + st.ctm[:3, 3]
                        geom = Geometry(vertices=Pw, indices=idx, uvs=uvs)
                    except Exception as e:  # noqa: BLE001
                        print(f"Warning: failed to load plymesh {fname}: {e}")
                else:
                    print(f"Unsupported shape type '{stype}' skipped")
                if geom is not None and geom.num_tris > 0:
                    add_shape(geom, st)
            else:
                # unknown directive: consume its parameter list if present
                _parse_params(ts)

    parse_file(path, [_GState()], [False])

    scene.validate_materials()
    if not scene.lights:
        print("No lights found in PBRT scene, generating one")
        scene.lights = [default_obj_light()]
    return scene
