"""Vectorized math helpers of the plain reference: a frozen copy of
chameleonrt_tpu_torch/ops/math.py.

All functions take batched (..., 3) float32 tensors. Dot products are written
out component by component so the summation order is fixed (x, then y, then
z) on every device.
"""

from __future__ import annotations

import torch

M_PI = 3.14159265358979323846
M_1_PI = 0.318309886183790671538
EPSILON = 1e-4  # reference backends/embree/util.ih:8
MAX_PATH_DEPTH = 5  # reference backends/embree/util.ih:10


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v, eps: float = 1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def luminance(c):
    """Rec.709 luminance (reference backends/embree/util.ih:24-26)."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(x, y, s):
    return x * (1.0 - s) + y * s


def sqr(x):
    return x * x


def reflect(i, n):
    """Mirror direction (reference backends/embree/util.ih:71-73)."""
    return i - 2.0 * n * dot(i, n)[..., None]


def refract(i, n, eta):
    """Refraction; 0 on total internal reflection (util.ih:75-82)."""
    n_dot_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    k = torch.clamp(k, min=0.0)
    out = eta[..., None] * i - (eta * n_dot_i + torch.sqrt(k))[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(out), out)


def ortho_basis(n):
    """Right-handed orthonormal basis around n (util.ih:32-46): the helper
    axis is the first component of n smaller than 0.6 in magnitude.
    Returns (v_x, v_y)."""
    ax = n[..., 0].abs() < 0.6
    ay = n[..., 1].abs() < 0.6
    az = n[..., 2].abs() < 0.6
    hx = ax | (~ax & ~ay & ~az)
    hy = ~ax & ay
    hz = ~ax & ~ay & az
    v_y0 = torch.stack([hx, hy, hz], dim=-1).to(n.dtype)
    v_x = normalize(cross(v_y0, n))
    v_y = normalize(cross(n, v_x))
    return v_x, v_y


def power_heuristic(n_f, pdf_f, n_g, pdf_g):
    """Veach power heuristic, beta=2 (disney_bsdf.ih:68-72)."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    return sqr(f) / torch.clamp(sqr(f) + sqr(g), min=1e-20)


def linear_to_srgb(x):
    """linear -> sRGB transfer curve (util.ih:17-22)."""
    x = torch.clamp(x, min=0.0)
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055,
    )

