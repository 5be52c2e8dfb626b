"""Ray/triangle intersection (torch): the counterpart of
chameleonrt_tpu/ops/intersect.py. Constants, the hit payload, batched
Möller–Trumbore and the brute-force closest / any hit over all triangles,
which is the `reference` backend's traversal and the oracle of the BVH
walks.

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

    @staticmethod
    def none(n: int, device) -> "Hit":
        """n lanes that hit nothing."""
        return Hit(
            t=torch.full((n,), T_MAX, dtype=torch.float32, device=device),
            tri=torch.full((n,), -1, dtype=torch.int32, device=device),
            inst=torch.full((n,), -1, dtype=torch.int32, device=device),
            u=torch.zeros((n,), dtype=torch.float32, device=device),
            v=torch.zeros((n,), dtype=torch.float32, device=device),
        )

    @property
    def hit(self):
        return self.tri >= 0

    def merge(self, other: "Hit") -> "Hit":
        """Keep the nearer of two hits per lane (self on a tie)."""
        take = other.t < self.t
        return Hit(*(torch.where(take, o, s) for s, o in zip(self, other)))


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


# triangles of one step of the brute force, as in the JAX function: the
# within-block tie rule (first minimum) depends on it
BLOCK = 512
# ray-triangle pairs of one step of the brute force: the (R_chunk, BLOCK)
# intermediates are materialised, 64 MB a float32 tensor at 2**24
MAX_PAIRS = 1 << 24


def _triangle_blocks(v0, e1, e2):
    """(n_blocks, BLOCK, 3) views of the triangles, padded with degenerate
    triangles (e1 = e2 = 0), which never hit."""
    pad = -v0.shape[0] % BLOCK
    if pad:
        z = v0.new_zeros((pad, 3))
        v0, e1, e2 = (torch.cat([a, z]) for a in (v0, e1, e2))
    n = v0.shape[0] // BLOCK
    return v0.reshape(n, BLOCK, 3), e1.reshape(n, BLOCK, 3), e2.reshape(n, BLOCK, 3)


def _ray_chunks(R: int):
    """Slices of at most max(1, MAX_PAIRS // BLOCK) rays. A ray's answer
    does not depend on the other rays, so the tiling changes no result."""
    step = max(1, MAX_PAIRS // BLOCK)
    return [slice(s, min(s + step, R)) for s in range(0, R, step)]


def _lanes(x, sl):
    """A scalar, or the chunk's lanes of a per-ray (R,) tensor as (R_chunk, 1)."""
    return x[sl, None] if torch.is_tensor(x) and x.dim() > 0 else x


def brute_force_closest(orig, dir, v0, e1, e2, t_min=0.0, t_max=T_MAX):
    """All-pairs closest hit of rays (R, 3) against triangles (T, 3),
    over triangle blocks of BLOCK and chunks of rays of at most
    MAX_PAIRS ray-triangle pairs. Returns (t, tri, u, v) with tri = -1 on
    a miss. Ties go to the lowest triangle index within a block (argmin
    takes the first minimum) and to the earlier block across blocks
    (strict <), as in the JAX function. t_min and t_max are scalars or
    per-ray (R,) tensors."""
    R, dev = orig.shape[0], orig.device
    best_t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    bv0, be1, be2 = _triangle_blocks(v0, e1, e2)
    for sl in _ray_chunks(R):
        o, d = orig[sl, None, :], dir[sl, None, :]
        t_lo, t_hi = _lanes(t_min, sl), _lanes(t_max, sl)
        rows = torch.arange(o.shape[0], device=dev)
        ct, ctri, cu, cv = best_t[sl], best_tri[sl], best_u[sl], best_v[sl]
        for b in range(bv0.shape[0]):
            hit, t, u, v = moller_trumbore(o, d, bv0[b][None], be1[b][None], be2[b][None],
                                           t_lo, t_hi)
            t = torch.where(hit, t, T_MAX)
            arg = torch.argmin(t, dim=1)
            bt = t[rows, arg]
            take = bt < ct
            ct = torch.where(take, bt, ct)
            ctri = torch.where(take, (arg + b * BLOCK).to(torch.int32), ctri)
            cu = torch.where(take, u[rows, arg], cu)
            cv = torch.where(take, v[rows, arg], cv)
        best_t[sl], best_tri[sl], best_u[sl], best_v[sl] = ct, ctri, cu, cv
    return best_t, best_tri, best_u, best_v


def brute_force_any(orig, dir, v0, e1, e2, t_min=0.0, t_max=T_MAX):
    """All-pairs any hit (occlusion) of rays (R, 3) against triangles
    (T, 3): (R,) bool. Blocks, ray chunks and per-ray t_min / t_max as in
    brute_force_closest."""
    R = orig.shape[0]
    occluded = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    bv0, be1, be2 = _triangle_blocks(v0, e1, e2)
    for sl in _ray_chunks(R):
        o, d = orig[sl, None, :], dir[sl, None, :]
        t_lo, t_hi = _lanes(t_min, sl), _lanes(t_max, sl)
        occ = occluded[sl]
        for b in range(bv0.shape[0]):
            hit, _, _, _ = moller_trumbore(o, d, bv0[b][None], be1[b][None], be2[b][None],
                                           t_lo, t_hi)
            occ = occ | hit.any(dim=1)
        occluded[sl] = occ
    return occluded
