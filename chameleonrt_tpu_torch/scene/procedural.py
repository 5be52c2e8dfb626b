"""Procedural benchmark/test scenes.

The reference is benchmarked on downloaded scenes (Sponza, Rungholt, San
Miguel; README.md:9-11). This environment ships no assets, so the framework
provides deterministic procedural scenes with comparable triangle counts and
divergence characteristics for tests and benchmarks. They are also exposed
through the CLI via the ``proc://`` scheme (e.g. ``proc://cornell``).
"""

from __future__ import annotations

import numpy as np

from chameleonrt_tpu_torch.scene.types import (
    Camera,
    DisneyMaterial,
    Geometry,
    Instance,
    Mesh,
    ParameterizedMesh,
    QuadLight,
    Scene,
    ortho_basis,
)


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (ccw)."""
    verts = np.array([a, b, c, d], dtype=np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.uint32)
    return verts, idx


def _merge(parts):
    verts = []
    idx = []
    off = 0
    for v, i in parts:
        verts.append(v)
        idx.append(i + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(idx)


def _box(lo, hi):
    """Axis-aligned box as 12 triangles with outward normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    parts = [
        _quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        _quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # -z
        _quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # +x
        _quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        _quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # +y
        _quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # -y
    ]
    return _merge(parts)


# corner index (of the 8 box corners in (x,y,z) bit order: bit0=z hi,
# bit1=y hi, bit2=x hi) triples for the 12 outward-facing triangles —
# the same winding as _box above
_BOX_TRI_TEMPLATE = np.array(
    [
        [1, 5, 7], [1, 7, 3],  # +z
        [4, 0, 2], [4, 2, 6],  # -z
        [5, 4, 6], [5, 6, 7],  # +x
        [0, 1, 3], [0, 3, 2],  # -x
        [3, 7, 6], [3, 6, 2],  # +y
        [0, 4, 5], [0, 5, 1],  # -y
    ],
    dtype=np.uint32,
)


def _boxes_vec(lo, hi):
    """Vectorized axis-aligned boxes: lo/hi (N, 3) -> (verts (8N, 3) f32,
    idx (12N, 3) u32). Matches _box's outward winding; used for
    million-box scenes where a Python loop would take minutes."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    n = lo.shape[0]
    corners = np.empty((n, 8, 3), np.float32)
    for ci in range(8):
        corners[:, ci, 0] = hi[:, 0] if (ci & 4) else lo[:, 0]
        corners[:, ci, 1] = hi[:, 1] if (ci & 2) else lo[:, 1]
        corners[:, ci, 2] = hi[:, 2] if (ci & 1) else lo[:, 2]
    verts = corners.reshape(-1, 3)
    idx = (
        _BOX_TRI_TEMPLATE[None, :, :]
        + (np.arange(n, dtype=np.uint32) * 8)[:, None, None]
    ).reshape(-1, 3)
    return verts, idx


def cornell_box(light_emission: float = 10.0) -> Scene:
    """The classic Cornell box: white floor/ceiling/back, red left wall,
    green right wall, two boxes, quad light at the ceiling."""
    scene = Scene()
    white = DisneyMaterial(base_color=np.array([0.73, 0.73, 0.73], np.float32))
    red = DisneyMaterial(base_color=np.array([0.65, 0.05, 0.05], np.float32))
    green = DisneyMaterial(base_color=np.array([0.12, 0.45, 0.15], np.float32))
    scene.materials = [white, red, green]

    s = 1.0  # half-extent; box spans [-1, 1]^3 with open front
    white_parts = [
        _quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]),  # floor
        _quad([-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]),  # ceiling
        _quad([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]),  # back wall
    ]
    # Two interior boxes
    white_parts.append(_box([-0.65, -1.0, -0.6], [-0.05, 0.2, -0.05]))
    white_parts.append(_box([0.1, -1.0, -0.2], [0.65, -0.45, 0.45]))
    wv, wi = _merge(white_parts)
    lv, li = _quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s])  # left (red)
    rv, ri = _quad([s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s])  # right (green)

    mesh = Mesh(
        geometries=[
            Geometry(vertices=wv, indices=wi),
            Geometry(vertices=lv, indices=li),
            Geometry(vertices=rv, indices=ri),
        ]
    )
    scene.meshes = [mesh]
    scene.parameterized_meshes = [ParameterizedMesh(0, [0, 1, 2])]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]

    normal = np.array([0.0, -1.0, 0.0], np.float32)
    v_x, v_y = ortho_basis(normal)
    width, height = 0.5, 0.5
    # Quad spans position + [0,w]*v_x + [0,h]*v_y; center it at the ceiling.
    position = (
        np.array([0.0, 0.99, 0.0], np.float32) - 0.5 * width * v_x - 0.5 * height * v_y
    )
    scene.lights = [
        QuadLight(
            emission=np.full(3, light_emission, np.float32),
            position=position,
            normal=normal,
            v_x=v_x,
            v_y=v_y,
            width=width,
            height=height,
        )
    ]
    scene.cameras = [
        Camera(
            position=np.array([0.0, 0.0, 3.6], np.float32),
            center=np.zeros(3, np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov_y=40.0,
        )
    ]
    return scene


def _subdivide_quads(verts, idx, levels: int):
    """Subdivide each triangle (1 -> 4) `levels` times to raise tri count."""
    for _ in range(levels):
        v0 = verts[idx[:, 0]]
        v1 = verts[idx[:, 1]]
        v2 = verts[idx[:, 2]]
        m01 = 0.5 * (v0 + v1)
        m12 = 0.5 * (v1 + v2)
        m20 = 0.5 * (v2 + v0)
        base = len(verts)
        n = len(idx)
        verts = np.concatenate([verts, m01, m12, m20]).astype(np.float32)
        a = idx[:, 0]
        b = idx[:, 1]
        c = idx[:, 2]
        i01 = base + np.arange(n, dtype=np.uint32)
        i12 = base + n + np.arange(n, dtype=np.uint32)
        i20 = base + 2 * n + np.arange(n, dtype=np.uint32)
        idx = np.concatenate(
            [
                np.stack([a, i01, i20], 1),
                np.stack([i01, b, i12], 1),
                np.stack([i20, i12, c], 1),
                np.stack([i01, i12, i20], 1),
            ]
        ).astype(np.uint32)
    return verts, idx


def hall(columns: int = 8, subdiv: int = 3, seed: int = 7, textured: int = 0) -> Scene:
    """"Sponza-like" procedural atrium: a long hall with rows of columns,
    boxes, and subdivided walls. With the defaults it lands around 250-300K
    triangles, similar to Sponza's ~260K, with comparable occlusion and
    divergence character (long sight lines, many small occluders).
    ``textured=1`` adds a procedural diffuse texture (Sponza is textured, so
    benchmarks should exercise the atlas-sampling path) with box-projected
    UVs."""
    rng = np.random.default_rng(seed)
    L, W, H = 20.0, 8.0, 6.0
    # Open-topped atrium like Sponza: partial ceiling slabs along the rims,
    # open in the middle so the overhead quad light illuminates the interior.
    parts = [
        _quad([-L, 0, -W], [L, 0, -W], [L, 0, W], [-L, 0, W]),  # floor
        _quad([-L, H, W], [L, H, W], [L, H, W - 2.5], [-L, H, W - 2.5]),  # rim +z
        _quad([-L, H, -W + 2.5], [L, H, -W + 2.5], [L, H, -W], [-L, H, -W]),  # rim -z
        _quad([-L, 0, W], [L, 0, W], [L, H, W], [-L, H, W]),  # +z wall
        _quad([L, 0, -W], [-L, 0, -W], [-L, H, -W], [L, H, -W]),  # -z wall
        _quad([-L, 0, -W], [-L, 0, W], [-L, H, W], [-L, H, -W]),  # -x wall
        _quad([L, 0, W], [L, 0, -W], [L, H, -W], [L, H, W]),  # +x wall
    ]
    # group: name -> list of (verts, idx) parts. Untextured keeps one flat
    # group; textured=1 splits surface families into their own geometries
    # so each carries its own material (Sponza's character: ~25 materials /
    # dozens of textures — reference loads them via stb + per-geometry
    # material ids, util/mesh.h:28-36).
    groups = {
        "floor": [parts[0]],
        "rims": parts[1:3],
        "walls_z": parts[3:5],
        "walls_x": parts[5:7],
        "capitals": [],
        "clutter0": [], "clutter1": [], "clutter2": [],
        "clutter3": [], "clutter4": [], "clutter5": [],
        "col0": [], "col1": [], "col2": [], "col3": [], "col4": [], "col5": [],
    }
    # Colonnades: two rows of square columns
    xs = np.linspace(-L + 2.0, L - 2.0, columns)
    ci = 0
    for x in xs:
        for z in (-W + 2.0, W - 2.0):
            groups[f"col{ci % 6}"].append(
                _box([x - 0.4, 0.0, z - 0.4], [x + 0.4, H - 1.0, z + 0.4])
            )
            # capital on top of each column
            groups["capitals"].append(
                _box([x - 0.6, H - 1.0, z - 0.6], [x + 0.6, H - 0.7, z + 0.6])
            )
            ci += 1
    # Clutter boxes on the floor
    for bi in range(40):
        cx = rng.uniform(-L + 1, L - 1)
        cz = rng.uniform(-W + 1, W - 1)
        sx, sy, sz = rng.uniform(0.2, 1.2, 3)
        groups[f"clutter{bi % 6}"].append(
            _box([cx - sx, 0.0, cz - sz], [cx + sx, sy, cz + sz])
        )

    scene = Scene()
    if not textured:
        verts, idx = _merge([p for ps in groups.values() for p in ps])
        verts, idx = _subdivide_quads(verts, idx, subdiv)
        scene.materials = [
            DisneyMaterial(base_color=np.array([0.75, 0.71, 0.68], np.float32))
        ]
        scene.meshes = [Mesh(geometries=[Geometry(vertices=verts, indices=idx)])]
        scene.parameterized_meshes = [ParameterizedMesh(0, [0])]
    else:
        from chameleonrt_tpu_torch.scene.texture_mask import make_texture_handle

        texes, rough_tex = _tex_library(512)
        scene.textures = texes

        def tex_mat(tex_id=None, color=(0.75, 0.71, 0.68), rough=0.5, **kw):
            m = DisneyMaterial(
                base_color=np.array(color, np.float32), roughness=rough, **kw
            )
            if tex_id is not None:
                m.set_color_texture(tex_id)
            return m

        rough_handle = make_texture_handle(rough_tex, 0)
        # group name -> (material, uv scale); 17 materials over 8 textures,
        # mixing base_color texture handles with roughness texture handles
        spec = {
            "floor": (tex_mat(5, rough=float(rough_handle)), 0.35),
            "rims": (tex_mat(6), 0.5),
            "walls_z": (tex_mat(0), 0.5),
            "walls_x": (tex_mat(1), 0.5),
            "capitals": (
                tex_mat(None, color=(0.9, 0.74, 0.35), rough=0.25, metallic=0.8),
                1.0,
            ),
            "col0": (tex_mat(2, rough=0.3), 0.8),
            "col1": (tex_mat(2, rough=float(rough_handle)), 1.2),
            "col2": (tex_mat(None, color=(0.62, 0.6, 0.58), rough=0.7), 1.0),
            "col3": (tex_mat(2, rough=0.15, specular=0.6), 0.6),
            "col4": (tex_mat(6, rough=0.8), 1.0),
            "col5": (tex_mat(None, color=(0.5, 0.42, 0.38), rough=float(rough_handle)), 1.0),
            "clutter0": (tex_mat(3, rough=0.6), 0.9),
            "clutter1": (tex_mat(4, rough=0.4), 0.7),
            "clutter2": (tex_mat(None, color=(0.7, 0.25, 0.2), rough=0.5), 1.0),
            "clutter3": (tex_mat(3, rough=float(rough_handle)), 1.4),
            "clutter4": (tex_mat(None, color=(0.2, 0.4, 0.65), rough=0.3, specular=0.5), 1.0),
            "clutter5": (tex_mat(5, rough=0.9), 0.5),
        }
        geoms = []
        mat_ids = []
        for name, (mat, uv_scale) in spec.items():
            ps = groups[name]
            if not ps:
                continue
            gv, gidx = _merge(ps)
            gv, gidx = _subdivide_quads(gv, gidx, subdiv)
            uvs = ((gv[:, [0, 1]] + gv[:, [2, 2]] * 0.25) * 0.5 * uv_scale).astype(
                np.float32
            )
            mat_ids.append(len(scene.materials))
            scene.materials.append(mat)
            geoms.append(Geometry(vertices=gv, indices=gidx, uvs=uvs))
        scene.meshes = [Mesh(geometries=geoms)]
        scene.parameterized_meshes = [ParameterizedMesh(0, mat_ids)]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]

    # sun-like quad above the open atrium roof, tilted slightly
    normal = np.array([0.15, -0.95, 0.1], np.float32)
    normal /= np.linalg.norm(normal)
    v_x, v_y = ortho_basis(normal)
    width, height = 10.0, 4.0
    position = (
        np.array([0.0, H + 4.0, 0.0], np.float32)
        - 0.5 * width * v_x
        - 0.5 * height * v_y
    )
    scene.lights = [
        QuadLight(
            emission=np.full(3, 25.0, np.float32),
            position=position,
            normal=normal,
            v_x=v_x,
            v_y=v_y,
            width=width,
            height=height,
        )
    ]
    scene.cameras = [
        Camera(
            position=np.array([-16.0, 3.0, 0.0], np.float32),
            center=np.array([10.0, 2.0, 0.0], np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov_y=65.0,
        )
    ]
    return scene


def _tex_library(size: int = 512):
    """Eight deterministic procedural textures at ``size``² (the honest
    Sponza-like texture mix: the real scene carries dozens of textures up
    to 1024² — reference loads them via stb, util/material.h:11-27).
    Returns (list of Image, roughness_tex_index)."""
    from chameleonrt_tpu_torch.scene.types import ColorSpace, Image

    s = size
    ty, tx = np.mgrid[0:s, 0:s].astype(np.float32)
    rng = np.random.default_rng(3)
    noise = rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)
    # smooth-ish turbulence from shifted copies (cheap, deterministic)
    turb = (
        noise
        + np.roll(noise, s // 7, 0)
        + np.roll(noise, s // 13, 1)
        + np.roll(noise, (s // 3, s // 5), (0, 1))
    ) * 0.25

    def rgb(r, g, b):
        return np.stack(
            [
                np.clip(r * 255.0, 0, 255).astype(np.uint8),
                np.clip(g * 255.0, 0, 255).astype(np.uint8),
                np.clip(b * 255.0, 0, 255).astype(np.uint8),
            ],
            axis=-1,
        )

    texes = []

    def add(name, data, space=ColorSpace.SRGB):
        texes.append(Image(name=name, data=data, color_space=space))

    # 0: red brick
    brick = (((ty // 64 + tx // 128) % 2) * 0.25 + 0.55) + 0.1 * noise
    mortar = ((ty % 64 < 6) | (tx % 128 < 6)).astype(np.float32)
    base = np.where(mortar > 0, 0.68, brick)
    add("brick_red", rgb(base * 0.85, base * 0.45, base * 0.36))
    # 1: gray brick
    add("brick_gray", rgb(base * 0.62, base * 0.6, base * 0.58))
    # 2: marble — banded turbulence
    bands = 0.5 + 0.5 * np.sin(tx * 0.05 + turb * 12.0)
    marble = 0.7 + 0.3 * bands
    add("marble", rgb(marble, marble * 0.97, marble * 0.92))
    # 3: wood rings
    cx, cyy = s * 0.3, s * 0.6
    r = np.sqrt((tx - cx) ** 2 + (ty - cyy) ** 2)
    rings = 0.5 + 0.5 * np.sin(r * 0.25 + turb * 6.0)
    add("wood", rgb(0.45 + 0.2 * rings, 0.28 + 0.14 * rings, 0.12 + 0.08 * rings))
    # 4: checker
    chk = ((ty // 64 + tx // 64) % 2).astype(np.float32)
    add("checker", rgb(0.2 + 0.7 * chk, 0.2 + 0.7 * chk, 0.22 + 0.68 * chk))
    # 5: stone tiles
    tile = ((ty % 128 < 8) | (tx % 128 < 8)).astype(np.float32)
    stone = np.where(tile > 0, 0.35, 0.55 + 0.25 * turb)
    add("stone_tiles", rgb(stone, stone * 0.98, stone * 0.93))
    # 6: plaster (smooth warm noise)
    plaster = 0.72 + 0.18 * turb
    add("plaster", rgb(plaster, plaster * 0.93, plaster * 0.82))
    # 7: roughness noise (LINEAR single-channel payload in R)
    rough = 0.3 + 0.55 * turb
    add("roughness_noise", rgb(rough, rough, rough), ColorSpace.LINEAR)
    return texes, 7


def voxel_city(n: int = 610, seed: int = 9, street: float = 2.0) -> Scene:
    """Rungholt-style voxel city: an n x n grid of axis-aligned block
    buildings (one or two stacked boxes each) over a ground plane —
    structured, coherently occluded geometry at Rungholt scale (the real
    Rungholt is a 6.7M-tri Minecraft city, reference README.md:9-11), in
    contrast to the adversarially divergent proc://random soup. n=610
    lands ~6.7M triangles."""
    rng = np.random.default_rng(seed)
    # building footprints on a street grid
    gi, gj = np.mgrid[0:n, 0:n].astype(np.float32)
    cxs = (gi.reshape(-1) - (n - 1) / 2) * street
    czs = (gj.reshape(-1) - (n - 1) / 2) * street
    nb = n * n
    half = rng.uniform(0.55, 0.95, nb).astype(np.float32) * (street * 0.45)
    # quantized voxel heights, clustered into districts via smooth field
    district = (
        np.sin(gi * 0.05).reshape(-1) * np.cos(gj * 0.07).reshape(-1) + 1.0
    )
    h = (1.0 + np.floor(rng.uniform(0, 4, nb) + district * 2.5)).astype(np.float32)
    lo1 = np.stack([cxs - half, np.zeros(nb, np.float32), czs - half], 1)
    hi1 = np.stack([cxs + half, h, czs + half], 1)
    # ~half the buildings get a smaller tower on top (raises tris/building
    # to ~18 average and gives a skyline)
    tower = rng.uniform(size=nb) < 0.5
    th = h + rng.uniform(1.0, 3.0, nb).astype(np.float32)
    th2 = half * 0.5
    lo2 = np.stack([cxs - th2, h, czs - th2], 1)[tower]
    hi2 = np.stack([cxs + th2, th, czs + th2], 1)[tower]
    lo = np.concatenate([lo1, lo2])
    hi = np.concatenate([hi1, hi2])
    verts, idx = _boxes_vec(lo, hi)
    # ground plane
    ext = (n / 2 + 2) * street
    gv, gidx = _quad([-ext, 0, -ext], [ext, 0, -ext], [ext, 0, ext], [-ext, 0, ext])
    verts, idx = _merge([(verts, idx), (gv, gidx)])

    scene = Scene()
    scene.materials = [
        DisneyMaterial(base_color=np.array([0.65, 0.6, 0.55], np.float32))
    ]
    scene.meshes = [Mesh(geometries=[Geometry(vertices=verts, indices=idx)])]
    scene.parameterized_meshes = [ParameterizedMesh(0, [0])]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]

    # sun quad high above, slightly tilted
    normal = np.array([0.25, -0.9, 0.2], np.float32)
    normal /= np.linalg.norm(normal)
    v_x, v_y = ortho_basis(normal)
    width = height = ext * 0.5
    position = (
        np.array([0.0, 40.0, 0.0], np.float32)
        - 0.5 * width * v_x
        - 0.5 * height * v_y
    )
    scene.lights = [
        QuadLight(
            emission=np.full(3, 20.0, np.float32),
            position=position,
            normal=normal,
            v_x=v_x,
            v_y=v_y,
            width=width,
            height=height,
        )
    ]
    # oblique aerial fly-over view (the classic Rungholt benchmark angle)
    scene.cameras = [
        Camera(
            position=np.array([-ext * 0.55, 28.0, -ext * 0.4], np.float32),
            center=np.array([ext * 0.15, 0.0, ext * 0.1], np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov_y=55.0,
        )
    ]
    return scene


def random_triangles(n_tris: int = 256, seed: int = 1, spread: float = 1.0) -> Scene:
    """Random triangle soup in [-spread, spread]^3 — stress-test scene for
    BVH build/traversal correctness checks against brute force."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 1, 3))
    offsets = rng.normal(0.0, 0.12 * spread, (n_tris, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n_tris * 3, dtype=np.uint32).reshape(-1, 3)

    scene = Scene()
    scene.materials = [DisneyMaterial()]
    scene.meshes = [Mesh(geometries=[Geometry(vertices=verts, indices=idx)])]
    scene.parameterized_meshes = [ParameterizedMesh(0, [0])]
    scene.instances = [Instance(np.eye(4, dtype=np.float32), 0)]
    from chameleonrt_tpu_torch.scene.types import default_obj_light

    scene.lights = [default_obj_light()]
    scene.cameras = [
        Camera(
            position=np.array([0.0, 0.0, 4.0 * spread], np.float32),
            center=np.zeros(3, np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov_y=55.0,
        )
    ]
    return scene


def instanced_grid(nx: int = 4, ny: int = 4, subdiv: int = 1) -> Scene:
    """A grid of instances of one box mesh — exercises the instancing path
    (multiple Instances sharing a ParameterizedMesh, reference util/mesh.h:40-47)."""
    verts, idx = _box([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4])
    verts, idx = _subdivide_quads(verts, idx, subdiv)
    scene = Scene()
    scene.materials = [
        DisneyMaterial(base_color=np.array([0.8, 0.3, 0.25], np.float32)),
        DisneyMaterial(base_color=np.array([0.25, 0.5, 0.8], np.float32)),
    ]
    scene.meshes = [Mesh(geometries=[Geometry(vertices=verts, indices=idx)])]
    scene.parameterized_meshes = [
        ParameterizedMesh(0, [0]),
        ParameterizedMesh(0, [1]),
    ]
    for i in range(nx):
        for j in range(ny):
            t = np.eye(4, dtype=np.float32)
            t[0, 3] = (i - (nx - 1) / 2) * 1.5
            t[1, 3] = (j - (ny - 1) / 2) * 1.5
            # alternate materials and add some rotation for non-axis-aligned AABBs
            ang = 0.4 * (i + 2 * j)
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            t[:3, :3] = rot
            scene.instances.append(Instance(t, (i + j) % 2))
    from chameleonrt_tpu_torch.scene.types import default_obj_light

    scene.lights = [default_obj_light()]
    scene.cameras = [
        Camera(
            position=np.array([0.0, 0.0, max(nx, ny) * 2.2], np.float32),
            center=np.zeros(3, np.float32),
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov_y=55.0,
        )
    ]
    return scene


PROCEDURAL_SCENES = {
    "cornell": cornell_box,
    "hall": hall,
    "random": random_triangles,
    "instances": instanced_grid,
    "city": voxel_city,
}


def make_procedural(name: str, **kwargs) -> Scene:
    if name not in PROCEDURAL_SCENES:
        raise ValueError(
            f"unknown procedural scene '{name}'; have {sorted(PROCEDURAL_SCENES)}"
        )
    return PROCEDURAL_SCENES[name](**kwargs)
