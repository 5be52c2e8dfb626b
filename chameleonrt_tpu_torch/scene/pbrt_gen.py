"""San Miguel-class PBRT scene generator.

BASELINE.json configs[4] names "San Miguel PBRTv3 (~10M tris) with quad
lights + NEE at 4 spp" (the reference showcases the real San Miguel,
README.md:9-11, loaded through util/scene.cpp:626-933). No assets ship with
the repository, so this writes a structurally comparable .pbrt scene —
an arcaded courtyard with a large instanced-foliage canopy — to disk at
bench time and loads it THROUGH scene/pbrt_loader.py: binary PLY meshes,
ObjectBegin/ObjectInstance instancing, named materials, a quad area light,
LookAt/Camera. The real San Miguel's character: ~10M total triangles,
most of them tiny foliage primitives, heavy instancing, deep occlusion.
"""

from __future__ import annotations

import os

import numpy as np


def _write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY (x,y,z float32; uchar-count int32 faces) —
    the format scene/pbrt_loader.read_ply consumes."""
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())


def _column_mesh(subdiv: int, rng) -> tuple:
    """A fluted column: stacked offset boxes, subdivided."""
    from chameleonrt_tpu_torch.scene.procedural import _box, _merge, _subdivide_quads

    parts = [
        _box([-0.35, 0.0, -0.35], [0.35, 0.5, 0.35]),  # base
        _box([-0.25, 0.5, -0.25], [0.25, 4.5, 0.25]),  # shaft
        _box([-0.4, 4.5, -0.4], [0.4, 5.0, 0.4]),  # capital
    ]
    v, i = _merge(parts)
    return _subdivide_quads(v, i, subdiv)


def _arch_mesh(subdiv: int) -> tuple:
    """An arch span between columns: lintel + parapet boxes."""
    from chameleonrt_tpu_torch.scene.procedural import _box, _merge, _subdivide_quads

    parts = [
        _box([-2.2, 5.0, -0.3], [2.2, 5.7, 0.3]),
        _box([-2.2, 5.7, -0.2], [2.2, 6.1, 0.2]),
    ]
    v, i = _merge(parts)
    return _subdivide_quads(v, i, subdiv)


def _foliage_mesh(n_leaves: int, radius: float, seed: int) -> tuple:
    """A canopy clump: n_leaves random small quads (2 tris each) inside a
    squashed sphere — the tiny-primitive, incoherent geometry that makes
    the real San Miguel's tree the hard part of the scene."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_leaves, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = radius * rng.uniform(0.3, 1.0, (n_leaves, 1)) ** 0.5
    centers = u * r * np.array([1.0, 0.6, 1.0])
    t1 = rng.normal(size=(n_leaves, 3))
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(u, t1)
    t2 /= np.maximum(np.linalg.norm(t2, axis=1, keepdims=True), 1e-6)
    s = rng.uniform(0.05, 0.14, (n_leaves, 1))
    a = centers - t1 * s - t2 * s
    b = centers + t1 * s - t2 * s
    c = centers + t1 * s + t2 * s
    d = centers - t1 * s + t2 * s
    verts = np.concatenate([a, b, c, d]).astype(np.float32)
    n = n_leaves
    i0 = np.arange(n, dtype=np.uint32)
    faces = np.concatenate(
        [
            np.stack([i0, i0 + n, i0 + 2 * n], 1),
            np.stack([i0, i0 + 2 * n, i0 + 3 * n], 1),
        ]
    ).astype(np.uint32)
    return verts, faces


def generate_san_miguel_proxy(
    out_dir: str,
    col_subdiv: int = 5,
    leaf_tris: int = 100_000,
    canopy_instances: int = 70,
    seed: int = 5,
) -> str:
    """Write the courtyard scene into out_dir; returns the .pbrt path.
    Defaults land ~10M total instanced triangles (like the real San
    Miguel's 9.96M) over ~600K unique. A tiny test variant:
    col_subdiv=1, leaf_tris=400, canopy_instances=4."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    from chameleonrt_tpu_torch.scene.procedural import _box, _merge, _subdivide_quads

    cv, ci = _column_mesh(col_subdiv, rng)
    _write_ply(os.path.join(out_dir, "column.ply"), cv, ci)
    av, ai = _arch_mesh(col_subdiv)
    _write_ply(os.path.join(out_dir, "arch.ply"), av, ai)
    for k in range(3):
        fv, fi = _foliage_mesh(leaf_tris // 2, 3.2, seed + k)
        _write_ply(os.path.join(out_dir, f"foliage{k}.ply"), fv, fi)
    # courtyard shell: floor + surrounding walls, moderately subdivided
    S = 24.0
    shell = [
        _box([-S, -0.3, -S], [S, 0.0, S]),
        _box([-S, 0.0, -S - 0.6], [S, 8.0, -S]),
        _box([-S, 0.0, S], [S, 8.0, S + 0.6]),
        _box([-S - 0.6, 0.0, -S], [-S, 8.0, S]),
        _box([S, 0.0, -S], [S + 0.6, 8.0, S]),
    ]
    sv, si = _merge(shell)
    sv, si = _subdivide_quads(sv, si, 3)
    _write_ply(os.path.join(out_dir, "shell.ply"), sv, si)

    lines = []
    w = lines.append
    w("# San Miguel-class procedural courtyard (generated at bench time)")
    w("LookAt -18 4.5 -14   6 2.5 6   0 1 0")
    w('Camera "perspective" "float fov" [62]')
    w("WorldBegin")
    w('MakeNamedMaterial "plaster" "string type" "matte" "rgb Kd" [0.74 0.70 0.62]')
    w('MakeNamedMaterial "stone" "string type" "matte" "rgb Kd" [0.55 0.53 0.50]')
    w(
        'MakeNamedMaterial "leaves" "string type" "plastic" '
        '"rgb Kd" [0.12 0.34 0.08] "rgb Ks" [0.08 0.08 0.08] '
        '"float roughness" [0.4]'
    )
    w('MakeNamedMaterial "wood" "string type" "matte" "rgb Kd" [0.32 0.2 0.1]')
    # sun: quad area light high above the courtyard, slightly tilted
    w("AttributeBegin")
    w('AreaLightSource "diffuse" "rgb L" [14 13 11]')
    w(
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point P" [-8 26 -4  8 26 -4  8 26 10  -8 26 10]'
    )
    w("AttributeEnd")
    # objects
    w('ObjectBegin "column"')
    w('NamedMaterial "plaster"')
    w('Shape "plymesh" "string filename" ["column.ply"]')
    w("ObjectEnd")
    w('ObjectBegin "arch"')
    w('NamedMaterial "stone"')
    w('Shape "plymesh" "string filename" ["arch.ply"]')
    w("ObjectEnd")
    for k in range(3):
        w(f'ObjectBegin "foliage{k}"')
        w('NamedMaterial "leaves"')
        w(f'Shape "plymesh" "string filename" ["foliage{k}.ply"]')
        w("ObjectEnd")
    w('ObjectBegin "shell"')
    w('NamedMaterial "stone"')
    w('Shape "plymesh" "string filename" ["shell.ply"]')
    w("ObjectEnd")
    w("AttributeBegin")
    w('ObjectInstance "shell"')
    w("AttributeEnd")
    # arcade: two-deep colonnade around the courtyard perimeter
    arcade = 18.0
    n_side = 9
    xs = np.linspace(-arcade, arcade, n_side)
    for x in xs:
        for z in (-arcade, arcade):
            for inset in (0.0, 3.5):
                w("AttributeBegin")
                w(f"Translate {x:.3f} 0 {z - np.sign(z) * inset:.3f}")
                w('ObjectInstance "column"')
                w("AttributeEnd")
    for z in xs[1:-1]:
        for x in (-arcade, arcade):
            w("AttributeBegin")
            w(f"Translate {x:.3f} 0 {z:.3f}")
            w('ObjectInstance "column"')
            w("AttributeEnd")
    # arches spanning neighbouring perimeter columns
    for k in range(n_side - 1):
        xm = 0.5 * (xs[k] + xs[k + 1])
        for z in (-arcade, arcade):
            w("AttributeBegin")
            w(f"Translate {xm:.3f} 0 {z:.3f}")
            w('ObjectInstance "arch"')
            w("AttributeEnd")
        for x in (-arcade, arcade):
            w("AttributeBegin")
            w(f"Translate {x:.3f} 0 {xm:.3f}")
            w("Rotate 90 0 1 0")
            w('ObjectInstance "arch"')
            w("AttributeEnd")
    # the tree: a trunk + many canopy clump instances filling the court
    w("AttributeBegin")
    w("Translate 4 0 4")
    w('ObjectInstance "column"')  # trunk stand-in (scaled look via overlap)
    w("AttributeEnd")
    for k in range(canopy_instances):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.0, 7.5)
        x = 4 + np.cos(ang) * rad
        z = 4 + np.sin(ang) * rad
        y = rng.uniform(4.5, 9.5)
        rot = rng.uniform(0, 360)
        w("AttributeBegin")
        w(f"Translate {x:.3f} {y:.3f} {z:.3f}")
        w(f"Rotate {rot:.1f} 0 1 0")
        w(f'ObjectInstance "foliage{k % 3}"')
        w("AttributeEnd")
    w("WorldEnd")

    path = os.path.join(out_dir, "courtyard.pbrt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
