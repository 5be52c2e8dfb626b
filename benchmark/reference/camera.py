"""Perspective camera rays of the plain reference: a frozen copy of
chameleonrt_tpu_torch/ops/camera.py.

Mirrors the reference's ViewParams (render_embree.cpp:149-159) and its
jittered primary rays (render_embree.ispc:216-229).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .vmath import normalize


class ViewParams(NamedTuple):
    """Host-side float32 numpy vectors, reused for the whole frame."""

    pos: np.ndarray  # (3,)
    dir_du: np.ndarray
    dir_dv: np.ndarray
    dir_top_left: np.ndarray


def compute_view_params(pos, dir, up, fov_y_deg, fb_width, fb_height) -> ViewParams:
    """dir_du / dir_dv / dir_top_left from eye, dir, up, fov_y and aspect
    (render_embree.cpp:149-159)."""
    pos = np.asarray(pos, np.float32)
    dir = np.asarray(dir, np.float32)
    dir = dir / np.linalg.norm(dir)
    up = np.asarray(up, np.float32)
    img_y = 2.0 * np.tan(np.radians(0.5 * fov_y_deg))
    img_x = img_y * float(fb_width) / float(fb_height)
    du = np.cross(dir, up)
    du = du / np.linalg.norm(du) * img_x
    dv = np.cross(du, dir)
    dv = -dv / np.linalg.norm(dv) * img_y
    top_left = dir - 0.5 * du - 0.5 * dv
    return ViewParams(
        pos=pos,
        dir_du=du.astype(np.float32),
        dir_dv=dv.astype(np.float32),
        dir_top_left=top_left.astype(np.float32),
    )


def generate_primary_rays(view: ViewParams, pixel_x, pixel_y, fb_width, fb_height, rng_state):
    """Jittered primary rays for integer pixel coordinates
    (render_embree.ispc:216-229). Draws jitter x then y, as the reference
    does. Returns (rng_state, origin, dir)."""
    dev = rng_state.device

    def vec(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rng_state, jx = rng.lcg_randomf(rng_state)
    rng_state, jy = rng.lcg_randomf(rng_state)
    px = (pixel_x.to(torch.float32) + jx) / fb_width
    py = (pixel_y.to(torch.float32) + jy) / fb_height
    d = normalize(
        px[..., None] * vec(view.dir_du)
        + py[..., None] * vec(view.dir_dv)
        + vec(view.dir_top_left)
    )
    origin = vec(view.pos).expand(d.shape).contiguous()
    return rng_state, origin, d


def miss_shader(dir):
    """Checkerboard environment shared by all reference backends
    (render_embree.ispc:183-196)."""
    u = (1.0 + torch.atan2(dir[..., 0], -dir[..., 2]) * (1.0 / math.pi)) * 0.5
    v = torch.arccos(torch.clamp(dir[..., 1], -1.0, 1.0)) * (1.0 / math.pi)
    check_x = (u * 10.0).to(torch.int32)
    check_y = (v * 10.0).to(torch.int32)
    bright = (dir[..., 1] > -0.1) & (((check_x + check_y) % 2) == 0)
    val = torch.where(
        bright, torch.full_like(u, 0.5), torch.full_like(u, 0.1)
    )
    return val[..., None].expand(val.shape + (3,))
