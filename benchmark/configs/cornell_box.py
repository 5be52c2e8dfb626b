"""The `cornell_box` configuration's generator: the Cornell Box as the
Cornell Program of Computer Graphics publishes it (cornell_box.json
`quads`, in millimetres), written as PBRT v3, which the program loads
through `scene.loader.load_scene`.

Each published quad (a, b, c, d) is the two triangles (a, b, c) and
(a, c, d). Everything sits in one object instanced once, so the program
traces it as a flat table (B1/B2), as it does a single mesh. The RefScene
states what the file says as ChameleonRT's PBRT loader reads it
(util/scene.cpp:626-933): matte -> base colour Kd; the area-light quad
becomes a quad light and stays in the scene as geometry with the default
material (white 0.9, roughness 1), which follows the named ones. The
seed moves only the camera (bench.camera_for), so every seed traces the
same scene with the same work.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.harness import scene_files
from benchmark.reference.path import Light

# named materials in file order, and the surfaces each covers
_MATERIALS = {
    "white": ((0.725, 0.71, 0.68), ("floor", "ceiling", "back_wall", "short_block", "tall_block")),
    "red": ((0.63, 0.065, 0.05), ("left_wall",)),
    "green": ((0.14, 0.45, 0.091), ("right_wall",)),
}
_LIGHT_L = (17.0, 12.0, 4.0)
_QUAD = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)


def _packed_materials():
    recs = []
    for kd, _ in _MATERIALS.values():
        rec = np.zeros(14, np.float32)
        rec[0:3] = kd
        rec[5] = 1.0  # DisneyMaterial's default roughness
        rec[12] = 1.5
        recs.append(rec)
    default = np.zeros(14, np.float32)
    default[0:3] = 0.9
    default[5] = 1.0
    default[12] = 1.5
    return recs + [default]


def _quads(cfg: dict, surface: str):
    q = np.asarray(cfg["quads"][surface], np.float32)
    return q.reshape(-1, 4, 3)


def _mesh(quads):
    """(vertices, indices) of quads (n, 4, 3), two triangles each."""
    n = quads.shape[0]
    idx = (_QUAD[None] + 4 * np.arange(n, dtype=np.uint32)[:, None, None]).reshape(-1, 3)
    return quads.reshape(-1, 3).astype(np.float32), idx


def light_quad(cfg: dict):
    """The published light quad, moved light_drop below the ceiling."""
    q = _quads(cfg, "light")[0].copy()
    q[:, 1] -= np.float32(cfg["light_drop"])
    return q


def _fmt(a):
    return " ".join(repr(float(x)) for x in np.asarray(a).reshape(-1))


def generate(out_dir: str, seed: int, cfg: dict, camera) -> tuple:
    """Write out_dir/cornell_box.pbrt. Returns (path, a function that makes
    the RefScene: the reference's own scene, made after the window)."""
    pos, center, up, fov = camera
    lines = ["# The Cornell Box (benchmark/configs/cornell_box.py)",
             "LookAt {}   {}   {}".format(_fmt(pos), _fmt(center), _fmt(up)),
             f'Camera "perspective" "float fov" [{float(fov)!r}]', "WorldBegin"]
    for name, (kd, _) in _MATERIALS.items():
        lines.append(f'MakeNamedMaterial "{name}" "string type" "matte" "rgb Kd" [{_fmt(kd)}]')
    lq = light_quad(cfg)
    lines += ['ObjectBegin "box"', "AttributeBegin",
              'AreaLightSource "diffuse" "rgb L" [{}]'.format(_fmt(_LIGHT_L)),
              f'Shape "trianglemesh" "integer indices" [{_fmt(_QUAD).replace(".0", "")}] "point P" [{_fmt(lq)}]',
              "AttributeEnd"]
    geoms = [(lq, _QUAD, None, len(_MATERIALS))]  # the light, with the default material
    for mat_id, (name, (_, surfaces)) in enumerate(_MATERIALS.items()):
        lines.append(f'NamedMaterial "{name}"')
        for s in surfaces:
            v, f = _mesh(_quads(cfg, s))
            lines.append(f'Shape "trianglemesh" "integer indices" [{" ".join(str(int(i)) for i in f.reshape(-1))}] '
                         f'"point P" [{_fmt(v)}]')
            geoms.append((v, f, None, mat_id))
    lines += ["ObjectEnd", 'ObjectInstance "box"', "WorldEnd"]
    path = os.path.join(out_dir, "cornell_box.pbrt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, lambda: scene_files.flatten([geoms], [(np.eye(4), 0)], _packed_materials(), [],
                                             [_area_light(lq)])


def _area_light(quad) -> Light:
    """The quad light ChameleonRT's PBRT loader makes of the area-light
    quad: the first triangle's normal, a basis around it, and the quad's
    extents along the basis from its centre."""
    center = quad.mean(axis=0)
    n = np.cross(quad[1] - quad[0], quad[2] - quad[0])
    n = (n / np.linalg.norm(n)).astype(np.float32)
    v_x, v_y = scene_files.ortho_basis(n)
    ext_x = float(np.abs((quad - center) @ v_x).max())
    ext_y = float(np.abs((quad - center) @ v_y).max())
    return Light(emission=np.asarray(_LIGHT_L, np.float32),
                 position=(center - v_x * ext_x - v_y * ext_y).astype(np.float32), normal=n,
                 v_x=v_x.astype(np.float32), v_y=v_y.astype(np.float32), width=2 * ext_x,
                 height=2 * ext_y)
