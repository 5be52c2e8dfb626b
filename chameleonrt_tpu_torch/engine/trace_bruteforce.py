"""Brute-force scene traversal (torch): every triangle of each instance's
mesh, the counterpart of chameleonrt_tpu/engine/trace_bruteforce.py.

The correctness oracle of the BVH traversal. Rays move into each
instance's object space (the parameterization preserves t, so closest
hits compare directly across instances), meet that mesh's triangle range,
and the nearest hit wins.
"""

from __future__ import annotations

import torch

from chameleonrt_tpu_torch.engine.device_scene import FlatScene, SceneMeta
from chameleonrt_tpu_torch.ops.intersect import T_MAX, Hit, brute_force_any, brute_force_closest
from chameleonrt_tpu_torch.ops.math import EPSILON, transform_point, transform_vector


def _instance_rays(flat: FlatScene, inst_id: int, orig, dir):
    inv = flat.inst_inv[inst_id]
    return transform_point(inv, orig), transform_vector(inv, dir)


def _mesh_triangles(flat: FlatScene, start: int, count: int):
    sl = slice(start, start + count)
    return flat.tri_v0[sl], flat.tri_e1[sl], flat.tri_e2[sl]


def make_trace_fns(meta: SceneMeta):
    """(trace_closest, trace_any) for this scene's static structure: one
    loop over the instances, each against its mesh's triangle range."""

    def trace_closest(flat: FlatScene, orig, dir, t_min, active) -> Hit:
        """Closest hit from t_min; tri is the global triangle id and inst
        the hit instance. A miss or masked lane is (T_MAX, -1, -1)."""
        best = Hit.none(orig.shape[0], orig.device)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            start, count = meta.mesh_tri_ranges[mesh_id]
            if count == 0:
                continue
            o, d = _instance_rays(flat, inst_id, orig, dir)
            t, tri, u, v = brute_force_closest(o, d, *_mesh_triangles(flat, start, count),
                                               t_min=t_min)
            found = tri >= 0
            cand = Hit(t=t, tri=torch.where(found, tri + start, -1).to(torch.int32),
                       inst=torch.where(found, inst_id, -1).to(torch.int32), u=u, v=v)
            best = best.merge(cand)
        return Hit(
            t=torch.where(active, best.t, T_MAX),
            tri=torch.where(active, best.tri, -1),
            inst=torch.where(active, best.inst, -1),
            u=best.u,
            v=best.v,
        )

    def trace_any(flat: FlatScene, orig, dir, t_max, mask):
        """Occlusion along (EPSILON, t_max) on the masked-in lanes."""
        occluded = torch.zeros(orig.shape[:1], dtype=torch.bool, device=orig.device)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            start, count = meta.mesh_tri_ranges[mesh_id]
            if count == 0:
                continue
            o, d = _instance_rays(flat, inst_id, orig, dir)
            occluded = occluded | brute_force_any(o, d, *_mesh_triangles(flat, start, count),
                                                  t_min=EPSILON, t_max=t_max)
        return occluded & mask

    return trace_closest, trace_any
