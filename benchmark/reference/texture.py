"""Texture atlas sampling of the plain reference: a frozen copy of
chameleonrt_tpu_torch/ops/texture.py.

All textures live in one atlas of pre-built bilinear quads: row i holds the
2x2 RGBA uint8 footprint [t(x,y), t(x+1,y), t(x,y+1), t(x+1,y+1)] with
wrap addressing folded in. A lookup is one (R, 16) row gather plus decode
on the lane; sRGB textures linearize after the gather with the same float
ops the reference runs at upload (util.cpp:102).

A (N, 4) int32 table gives each texture (quad-row offset, width, height,
flags): bit0 = rgb is sRGB, bit1 = alpha is sRGB. A material float slot
whose bits have the top bit set is a texture handle
(util/texture_channel_mask.h).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TextureAtlas(NamedTuple):
    atlas: torch.Tensor  # (P, 16) uint8 bilinear quad rows
    table: torch.Tensor  # (N, 4) int32: offset, width, height, flags

    @staticmethod
    def empty(device) -> "TextureAtlas":
        return TextureAtlas(
            atlas=torch.zeros((1, 16), dtype=torch.uint8, device=device),
            table=torch.tensor([[0, 1, 1, 0]], dtype=torch.int32, device=device),
        )


def build_quad_rows(rgba_u8: np.ndarray) -> np.ndarray:
    """(h, w, 4) uint8 image -> (h*w, 16) uint8 quad rows with wrap
    addressing: row (y*w + x) = [t(x,y), t(x+1 mod w, y), t(x, y+1 mod h),
    t(x+1 mod w, y+1 mod h)] (texture2d.ih:39-49)."""
    p = np.concatenate([rgba_u8, rgba_u8[:, :1]], axis=1)  # wrap column
    p = np.concatenate([p, p[:1]], axis=0)  # wrap row
    q = np.concatenate([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], axis=2)
    return np.ascontiguousarray(q.reshape(-1, 16), dtype=np.uint8)


def _srgb_to_linear(f):
    """Piecewise sRGB EOTF on [0, 1] floats (util.cpp:102)."""
    return torch.where(f <= 0.04045, f / 12.92, ((f + 0.055) / 1.055) ** 2.4)


def _quad_setup(atlas: TextureAtlas, tex_id, uv):
    """Bilinear footprint (texture2d.ih:39-49): returns the uint8 quad rows
    (..., 16), the fractional offsets tx, ty and the colour-space flags."""
    tex_id = torch.clamp(tex_id, 0, atlas.table.shape[0] - 1)
    rec = atlas.table[tex_id.long()]
    off, w, h = rec[..., 0], rec[..., 1], rec[..., 2]
    ux = uv[..., 0] * w.to(torch.float32) - 0.5
    uy = uv[..., 1] * h.to(torch.float32) - 0.5
    tx = ux - torch.floor(ux)
    ty = uy - torch.floor(uy)
    # C truncation before the wrap, as texture2d.ih:46 does
    xi = ux.to(torch.int32)
    yi = uy.to(torch.int32)
    x0 = torch.remainder(xi, torch.clamp(w, min=1))
    y0 = torch.remainder(yi, torch.clamp(h, min=1))
    rows = atlas.atlas[(off + y0 * w + x0).long()]
    return rows, tx, ty, rec[..., 3]


def sample_rgb(atlas: TextureAtlas, tex_id, uv):
    """Bilinear RGB fetch (texture2d.ih:39-60). Returns (..., 3)."""
    rows, tx, ty, flags = _quad_setup(atlas, tex_id, uv)
    f = rows.to(torch.float32) * (1.0 / 255.0)
    srgb = ((flags & 1) != 0)[..., None]
    tx = tx[..., None]
    ty = ty[..., None]

    def corner(c0):
        rgb = f[..., c0 : c0 + 3]
        return torch.where(srgb, _srgb_to_linear(rgb), rgb)

    return (
        corner(0) * (1.0 - tx) * (1.0 - ty)
        + corner(4) * tx * (1.0 - ty)
        + corner(8) * (1.0 - tx) * ty
        + corner(12) * tx * ty
    )


def sample_channel(atlas: TextureAtlas, tex_id, channel, uv):
    """Bilinear single-channel fetch (texture2d.ih:62-83)."""
    rows, tx, ty, flags = _quad_setup(atlas, tex_id, uv)
    f = rows.to(torch.float32) * (1.0 / 255.0)
    channel = torch.clamp(channel, 0, 3).long()
    # rgb channels linearize per bit0; channel 3 (alpha) per bit1
    srgb = torch.where(channel == 3, (flags & 2) != 0, (flags & 1) != 0)

    def pick(c0):
        v = torch.gather(f[..., c0 : c0 + 4], -1, channel[..., None])[..., 0]
        return torch.where(srgb, _srgb_to_linear(v), v)

    return (
        pick(0) * (1.0 - tx) * (1.0 - ty)
        + pick(4) * tx * (1.0 - ty)
        + pick(8) * (1.0 - tx) * ty
        + pick(12) * tx * ty
    )


def bits_of(x):
    """float32 -> its bit pattern as int64 in [0, 2**32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def is_textured(bits):
    return (bits & 0x80000000) != 0


def tex_id_of(bits):
    return (bits & 0x1FFFFFFF).to(torch.int32)


def tex_channel_of(bits):
    return ((bits >> 29) & 0x3).to(torch.int32)


def textured_scalar_param(atlas: TextureAtlas, x, uv):
    """Scalar parameter that may carry a texture handle
    (render_embree.ispc:66-77)."""
    bits = bits_of(x)
    fetched = sample_channel(atlas, tex_id_of(bits), tex_channel_of(bits), uv)
    return torch.where(is_textured(bits), fetched, x)


def textured_color_param(atlas: TextureAtlas, rgb, uv):
    """base_color whose red slot may carry an all-channel texture handle
    (render_embree.ispc:84-91)."""
    bits = bits_of(rgb[..., 0].contiguous())
    fetched = sample_rgb(atlas, tex_id_of(bits), uv)
    return torch.where(is_textured(bits)[..., None], fetched, rgb)
