"""Quad-light sampling of the plain reference: a frozen copy of
chameleonrt_tpu_torch/ops/lights.py.

The reference's quirks are kept on purpose (lights.ih:26-69), notably
quad_light_pdf taking the squared distance of ``p - dir`` (lights.ih:42).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .vmath import EPSILON, dot


class LightArrays(NamedTuple):
    """SoA quad-light table; after a gather the leading dim is the ray."""

    emission: torch.Tensor  # (..., 3)
    position: torch.Tensor
    normal: torch.Tensor
    v_x: torch.Tensor
    v_y: torch.Tensor
    width: torch.Tensor  # (...,)
    height: torch.Tensor

    @staticmethod
    def from_scene_lights(lights, device) -> "LightArrays":
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return LightArrays(
            emission=f32(np.stack([l.emission for l in lights])),
            position=f32(np.stack([l.position for l in lights])),
            normal=f32(np.stack([l.normal for l in lights])),
            v_x=f32(np.stack([l.v_x for l in lights])),
            v_y=f32(np.stack([l.v_y for l in lights])),
            width=f32([l.width for l in lights]),
            height=f32([l.height for l in lights]),
        )

    def gather(self, idx) -> "LightArrays":
        """Select one light per lane."""
        return LightArrays(*(f[idx] for f in self))

    def broadcast0(self, n: int) -> "LightArrays":
        """Light 0 for each of n lanes (the one-light scene)."""
        return LightArrays(*(f[0].expand((n,) + f.shape[1:]) for f in self))


def sample_quad_light_position(light: LightArrays, samples):
    """Point on the quad for uniform samples in [0,1]^2 (lights.ih:26-30)."""
    return (
        samples[..., 0:1] * light.v_x * light.width[..., None]
        + samples[..., 1:2] * light.v_y * light.height[..., None]
        + light.position
    )


def quad_light_pdf(light: LightArrays, p, orig, dir):
    """Solid-angle pdf of sampling p on the light (lights.ih:35-48, with its
    ``p - dir`` distance). ``orig`` is kept for signature parity."""
    del orig
    surface_area = light.width * light.height
    to_pt = p - dir
    dist_sqr = dot(to_pt, to_pt)
    n_dot_w = dot(light.normal, -dir)
    pdf = dist_sqr / torch.clamp(n_dot_w * surface_area, min=1e-20)
    return torch.where(n_dot_w < EPSILON, torch.zeros_like(pdf), pdf)


def quad_intersect(light: LightArrays, orig, dir):
    """Ray/quad intersection with the reference's half-extent convention
    (lights.ih:50-69). Returns (hit mask, t, light_pos)."""
    denom = dot(dir, light.normal)
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    t = dot(light.position - orig, light.normal) / denom_safe
    light_pos = orig + dir * t[..., None]
    hit_v = light_pos - light.position
    inside = (dot(hit_v, light.v_x).abs() < light.width) & (
        dot(hit_v, light.v_y).abs() < light.height
    )
    hit = (denom != 0.0) & (t >= 0.0) & inside
    return hit, t, light_pos
