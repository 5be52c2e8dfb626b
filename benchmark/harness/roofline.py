"""The table of peaks and the traversal kernels' least bytes.

A traversal kernel must at least read each traced ray's inputs once and
write its result once, whatever BVH or walk implements it. The byte
counts are those of the kernels' arguments (ops/traverse_cuda.py): orig
and dir (3 float32 each), t_min and t_max (float32), the lane's flag
(bool) in; t, prim, u, v (4 bytes each) and, over a two-level table, inst
out of a closest-hit kernel; one bool out of an any-hit kernel. Only the
live lanes count, so the least time can only understate what any
implementation needs, and the share can not pass 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

RAY_IN_BYTES = 12 + 12 + 4 + 4 + 1
CLOSEST_OUT_BYTES = {"flat": 16, "two_level": 20}
ANY_OUT_BYTES = 1


def least_bytes(closest_rays: float, any_rays: float, two_level: bool) -> float:
    out = CLOSEST_OUT_BYTES["two_level" if two_level else "flat"]
    return closest_rays * (RAY_IN_BYTES + out) + any_rays * (RAY_IN_BYTES + ANY_OUT_BYTES)


def least_seconds(closest_rays: float, any_rays: float, two_level: bool, card: str) -> float:
    peak = PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]
    return least_bytes(closest_rays, any_rays, two_level) / peak
