"""The `rtiow_final` configuration's generator: the final scene of Peter
Shirley's "Ray Tracing in One Weekend" (v3.2.3, section 13.1,
`random_scene`), written as a CRTS file, ChameleonRT's Blender-export
format, which the program loads through `scene.loader.load_scene`.

The sphere field follows `random_scene` in its draw order, from numpy's
default_rng(layout_seed): for each (a, b) of the grid, a-major, the
material choice, the centre's x, then its z; then, for a kept sphere, its
material's draws (diffuse: albedo = random() * random() per channel,
three draws and three more; metal: albedo in U(0.5, 1), three draws,
then the fuzz in U(0, 0.5)). The seed of a run moves only the camera
(bench.camera_for), so every seed traces the same field with the same work.

The program traces triangles only, as every ChameleonRT backend does. All
spheres instance one unit icosphere (mesh 1), each object's matrix scaling
and placing it; the ground is an icosphere of its own in world units
(mesh 0, identity matrix). The levels are the smallest whose largest chord
sag (the sagitta of the longest edge) is under a quarter of a pixel's
footprint at the focus distance (rtiow_final.json `tessellation`). Each
object carries its own material, as a Blender export does, so the loader
makes one parameterized mesh an object. The file has no light: the loader
generates its default one.

The RefScene states the same scene as world triangles (scene_files.flatten):
the ground, then every sphere in file order, each with its own material,
and the light the loader generates, made here by the same float32 steps.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from benchmark.harness import scene_files
from benchmark.reference.path import Light

# the 12 vertices and 20 outward (counter-clockwise) faces of the icosahedron
_PHI = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_V = np.array([(-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
                   (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
                   (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1)], np.float64)
_ICO_F = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                   (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                   (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                   (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)

# Disney parameters in the packed record's order (scene.types.MATERIAL_PARAM_NAMES),
# under the names a CRTS file gives them
_CRTS_PARAMS = ("metallic", "specular", "roughness", "specular_tint", "anisotropic", "sheen",
                "sheen_tint", "clearcoat", "clearcoat_roughness", "ior", "transmission")


def icosphere(level: int, faces=None):
    """A unit icosphere: the icosahedron's faces (or `faces` of them)
    split `level` times at their edges' midpoints, each new vertex pushed
    out to the sphere. Returns (vertices (V, 3) float64, faces (F, 3)
    int64), counter-clockwise seen from outside; a face's four children are
    consecutive, so faces near in the list are near on the sphere."""
    v = _ICO_V / np.linalg.norm(_ICO_V, axis=1, keepdims=True)
    f = _ICO_F if faces is None else _ICO_F[faces]
    for _ in range(level):
        n = v.shape[0]
        edges = np.sort(f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
        keys, inverse = np.unique(edges[:, 0] * n + edges[:, 1], return_inverse=True)
        mid = v[keys // n] + v[keys % n]
        v = np.concatenate([v, mid / np.linalg.norm(mid, axis=1, keepdims=True)])
        m01, m12, m20 = (inverse.reshape(-1, 3) + n).T
        a, b, c = f.T
        f = np.stack([np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
                      np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)], 1).reshape(-1, 3)
    return v, f


def largest_sags(level: int):
    """(chord, face) of a unit icosphere of `level`: the largest chord sag,
    the sagitta of its longest edge (how far the arc between two
    neighbouring vertices stands off the edge), and the largest face gap
    (how far the sphere stands off a face's plane, at the face's middle).
    The icosahedron's symmetry makes every base face's subdivision alike,
    so one base face's are the whole sphere's."""
    v, f = icosphere(level, faces=[0])
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    mids = np.concatenate([a + b, b + c, c + a]) / 2.0
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return (float(1.0 - np.linalg.norm(mids, axis=1).min()),
            float(1.0 - np.abs((n * a).sum(axis=1)).min()))


def random_scene(cfg: dict):
    """`random_scene`'s spheres [(centre (3,), radius, kind, albedo (3,),
    fuzz)]: the ground, the grid's kept spheres in draw order, then the
    three large spheres."""
    field = cfg["field"]
    rng = np.random.default_rng(int(cfg["layout_seed"]))
    spheres = [(np.asarray(field["ground_center"], np.float64), float(field["ground_radius"]),
                "diffuse", np.asarray(field["ground_albedo"], np.float64), 0.0)]
    lo, hi = field["grid"]
    avoid = np.asarray(field["avoid"], np.float64)
    r = float(field["small_radius"])
    for a in range(lo, hi):
        for b in range(lo, hi):
            choose = rng.random()
            x = a + 0.9 * rng.random()
            z = b + 0.9 * rng.random()
            center = np.array([x, r, z])
            if np.linalg.norm(center - avoid) <= field["avoid_radius"]:
                continue
            if choose < field["diffuse_below"]:
                albedo = rng.random(3) * rng.random(3)
                spheres.append((center, r, "diffuse", albedo, 0.0))
            elif choose < field["metal_below"]:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                spheres.append((center, r, "metal", albedo, fuzz))
            else:
                spheres.append((center, r, "glass", np.ones(3), 0.0))
    for s in field["large"]:
        spheres.append((np.asarray(s["center"], np.float64), float(s["radius"]), s["kind"],
                        np.asarray(s.get("albedo", (1.0, 1.0, 1.0)), np.float64),
                        float(s.get("fuzz", 0.0))))
    return spheres


def disney(kind: str, albedo, fuzz: float, ior: float) -> np.ndarray:
    """The packed 14-float Disney record of a book material, mapped as
    ChameleonRT's loaders map foreign ones: diffuse -> base colour, roughness
    1; metal -> metallic 1, base colour, roughness = fuzz; glass ->
    specular transmission 1 at ior, roughness 0, base colour 1."""
    rec = np.zeros(14, np.float32)
    rec[12] = ior
    if kind == "diffuse":
        rec[0:3] = albedo
        rec[5] = 1.0
    elif kind == "metal":
        rec[0:3] = albedo
        rec[3] = 1.0
        rec[5] = fuzz
    else:
        rec[0:3] = 1.0
        rec[13] = 1.0
    return rec


def generated_light() -> Light:
    """The quad light ChameleonRT's loaders generate for a scene without one
    (scene.types.default_obj_light), at the emission the CRTS loader gives
    it (10), by the same float32 steps."""
    normal = np.array([0.5, -0.8, -0.5], dtype=np.float32)
    normal /= np.linalg.norm(normal)
    v_x, v_y = scene_files.ortho_basis(normal)
    return Light(emission=np.full(3, 10.0, np.float32), position=(-10.0 * normal).astype(np.float32),
                 normal=normal, v_x=v_x.astype(np.float32), v_y=v_y.astype(np.float32), width=5.0,
                 height=5.0)


def _matrix(center, radius) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = radius
    m[:3, 3] = center
    return m


def meshes(cfg: dict):
    """(ground, sphere): each (vertices (V, 3) float32, faces (F, 3)
    uint32); the ground in world units, the sphere a unit one."""
    tess, field = cfg["tessellation"], cfg["field"]
    gv, gf = icosphere(int(tess["ground_level"]))
    gv = gv * float(field["ground_radius"]) + np.asarray(field["ground_center"], np.float64)
    sv, sf = icosphere(int(tess["sphere_level"]))
    return ((gv.astype(np.float32), gf.astype(np.uint32)), (sv.astype(np.float32), sf.astype(np.uint32)))


def _write_crts(path: str, header: dict, arrays) -> None:
    """A CRTS file: the JSON header's byte count (u64, little-endian), the
    header with one buffer view an array, then the arrays' bytes."""
    views, offset = [], 0
    for kind, a in arrays:
        views.append({"byte_offset": offset, "byte_length": a.nbytes, "type": kind})
        offset += a.nbytes
    header = dict(header, buffer_views=views)
    text = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, a in arrays:
            f.write(np.ascontiguousarray(a).tobytes())


def generate(out_dir: str, seed: int, cfg: dict, camera) -> tuple:
    """Write out_dir/rtiow_final.crts. Returns (path, a function that makes
    the RefScene, made after the window)."""
    spheres = random_scene(cfg)
    ior = float(cfg["field"]["ior"])
    records = [disney(kind, albedo, fuzz, ior) for _, _, kind, albedo, fuzz in spheres]
    (gv, gf), (sv, sf) = meshes(cfg)
    materials = []
    for rec in records:
        m = {"base_color": [float(x) for x in rec[0:3]]}
        m.update({name: float(rec[3 + i]) for i, name in enumerate(_CRTS_PARAMS)})
        materials.append(m)
    xforms = [np.eye(4, dtype=np.float32)] + [_matrix(c, r) for c, r, _, _, _ in spheres[1:]]
    objects = [{"type": "MESH", "name": f"sphere{i}", "mesh": 0 if i == 0 else 1, "material": i,
                "matrix": [float(x) for x in m.T.reshape(-1)]}  # column-major
               for i, m in enumerate(xforms)]
    header = {"meshes": [{"positions": 0, "indices": 1}, {"positions": 2, "indices": 3}],
              "materials": materials, "objects": objects}
    path = os.path.join(out_dir, "rtiow_final.crts")
    _write_crts(path, header, [("VEC3_F32", gv), ("VEC3_U32", gf), ("VEC3_F32", sv), ("VEC3_U32", sf)])

    def make_ref():
        geoms = [[(gv, gf, None, 0)]] + [[(sv, sf, None, i)] for i in range(1, len(spheres))]
        return scene_files.flatten(geoms, [(m, i) for i, m in enumerate(xforms)], records, [],
                                   [generated_light()])

    return path, make_ref
