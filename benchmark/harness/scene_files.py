"""The pieces of ChameleonRT's scene semantics that the generators need to
state what a scene file says as the reference's scene: the basis of a quad
light, and the world triangles of instanced meshes. The generators write
the files themselves (PBRT v3 text, which the program's loader reads
through ``scene.loader.load_scene(path)``).
"""

from __future__ import annotations

import numpy as np


def ortho_basis(n):
    """Right-handed orthonormal basis around n (ChameleonRT util.cpp:43-58)."""
    n = np.asarray(n, dtype=np.float32)
    v_y = np.zeros(3, dtype=np.float32)
    if -0.6 < n[0] < 0.6:
        v_y[0] = 1.0
    elif -0.6 < n[1] < 0.6:
        v_y[1] = 1.0
    elif -0.6 < n[2] < 0.6:
        v_y[2] = 1.0
    else:
        v_y[0] = 1.0
    v_x = np.cross(v_y, n)
    v_x /= np.linalg.norm(v_x)
    v_y = np.cross(n, v_x)
    v_y /= np.linalg.norm(v_y)
    return v_x, v_y


def flatten(meshes, instances, materials, textures, lights):
    """A RefScene from meshes [(vertices, indices, uvs or None, material id)]
    per geometry, grouped per mesh, and instances [(4x4 transform, mesh
    id)]: world triangles in instance order, then geometry order."""
    from benchmark.reference.path import RefScene

    v0s, e1s, e2s, uvs, mats = [], [], [], [], []
    for xform, mesh_id in instances:
        xform = np.asarray(xform, np.float64)
        for verts, idx, uv, mat in meshes[mesh_id]:
            w = (np.asarray(verts, np.float64) @ xform[:3, :3].T + xform[:3, 3]).astype(np.float32)
            idx = np.asarray(idx, np.int64)
            a, b, c = w[idx[:, 0]], w[idx[:, 1]], w[idx[:, 2]]
            v0s.append(a)
            e1s.append(b - a)
            e2s.append(c - a)
            if uv is None:
                uvs.append(np.zeros((len(idx), 6), np.float32))
            else:
                uvs.append(np.concatenate([uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]], axis=1))
            mats.append(np.full(len(idx), mat, np.int32))
    return RefScene(tri_v0=np.concatenate(v0s), tri_e1=np.concatenate(e1s),
                    tri_e2=np.concatenate(e2s), tri_uv=np.concatenate(uvs).astype(np.float32),
                    tri_mat=np.concatenate(mats), materials=np.asarray(materials, np.float32),
                    textures=textures, lights=lights)
