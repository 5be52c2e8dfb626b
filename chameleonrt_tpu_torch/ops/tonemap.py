"""Framebuffer tonemap (torch): linear accumulation -> sRGB8
(render_embree.ispc:358-370 tile_to_uint8)."""

from __future__ import annotations

import torch

from chameleonrt_tpu_torch.ops.math import linear_to_srgb


def linear_to_srgb_u8(accum):
    """(H, W, 3) float32 linear -> (H, W, 4) uint8 sRGB, opaque alpha."""
    srgb = torch.clamp(linear_to_srgb(accum), 0.0, 1.0)
    rgb8 = (srgb * 255.0 + 0.5).to(torch.uint8)
    alpha = torch.full(rgb8.shape[:-1] + (1,), 255, dtype=torch.uint8, device=accum.device)
    return torch.cat([rgb8, alpha], dim=-1)
