"""The comparison that decides `correct`: the program's sRGB8 image and ray
count against the plain reference's: the image on a sample of pixels
drawn from the seed, over every frame the run rendered, and the ray count
of the run's last frame whole.

Numbers read (each compared against its cell's limit where
cells/<cell>.json gives one):
- srgb_mad: the mean absolute difference of the sampled pixels' sRGB8
  channels, in levels of 255;
- srgb_bad_px: the share (%) of sampled pixels whose largest channel
  difference exceeds BAD_LEVELS levels;
- frame_rays_gap: the gap (%) between the rays the program counted in the
  frame it read the image back with (the run's last) and the rays the
  reference traces in that whole frame: the numerator of mrays_per_s.
"""

from __future__ import annotations

import numpy as np

BAD_LEVELS = 8
NAMES = ("srgb_mad", "srgb_bad_px", "frame_rays_gap")


def readings(port_u8: np.ndarray, ref_u8: np.ndarray, port_rays: int, ref_rays: int) -> dict:
    d = np.abs(port_u8.astype(np.int64) - ref_u8.astype(np.int64))
    return {
        "srgb_mad": float(d.mean()),
        "srgb_bad_px": float((d.max(axis=1) > BAD_LEVELS).mean() * 100.0),
        "frame_rays_gap": float(abs(port_rays - ref_rays) / max(ref_rays, 1) * 100.0),
    }


def judge(values: dict, limits: dict):
    """(correct, [[name, value, limit]]) over the numbers the cell has a
    limit for: correct when each is finite and within its limit."""
    rows = [[k, values[k], limits[k]] for k in NAMES if k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
