"""Ray/triangle intersection constants and the hit payload (torch): the
counterpart of chameleonrt_tpu/ops/intersect.py.

Triangles are (v0, e1, e2) with e1 = v1 - v0 and e2 = v2 - v0; the
geometric normal is cross(e1, e2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from chameleonrt_tpu_torch.ops.math import cross, dot

T_MAX = 1e20  # miss distance (float32 1e20)
_MT_EPS = 1e-9
# Barycentric boundary band that keeps shared edges watertight; the same
# float32 value in every intersection path (see the JAX module's note).
UV_EPS = float(np.float32(4e-6))
# 1 + UV_EPS rounded to float32, as the JAX path folds it
ONE_PLUS_UV_EPS = float(np.float32(1.0) + np.float32(4e-6))


class Hit(NamedTuple):
    """Closest-hit payload for a ray wavefront."""

    t: torch.Tensor  # (R,) float32, T_MAX when no hit
    tri: torch.Tensor  # (R,) int32 global triangle id, -1 miss, -2 overflow
    inst: torch.Tensor  # (R,) int32 instance id, -1 when no hit
    u: torch.Tensor  # (R,) float32 barycentric
    v: torch.Tensor

    @property
    def hit(self):
        return self.tri >= 0


def moller_trumbore(orig, dir, v0, e1, e2, t_min=0.0, t_max=T_MAX):
    """Batched Möller–Trumbore on broadcast (..., 3) rays and triangles.
    Returns (hit_mask, t, u, v)."""
    pvec = cross(dir, e2)
    det = dot(e1, pvec)
    small = det.abs() < _MT_EPS
    inv_det = 1.0 / torch.where(small, torch.ones_like(det), det)
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(dir, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        ~small
        & (u >= -UV_EPS)
        & (v >= -UV_EPS)
        & (u + v <= ONE_PLUS_UV_EPS)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v
