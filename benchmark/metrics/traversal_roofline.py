"""traversal_roofline: the traversal kernels' least time over their
device time, in % (layer: kernels). The least time moves each traced
ray's inputs once and its result once at the HBM peak (harness/roofline.py);
the profiled frames' rays are split between closest and any hit by the
share the reference counted on its lanes."""

from benchmark.harness.roofline import least_seconds
from benchmark.harness.trace import TRAVERSAL_KERNEL


def read(record):
    names_us = [(TRAVERSAL_KERNEL.search(name), e - s) for name, s, e in record.get("device_events") or []]
    us = sum(d for m, d in names_us if m)
    if not us or "closest_share" not in record:
        return None
    two_level = any(m and "unified" in m.group(1) for m, _ in names_us)
    rays = record["rays"]
    least = least_seconds(rays * record["closest_share"], rays * (1.0 - record["closest_share"]),
                          two_level, record["card"])
    return 100.0 * least / (us * 1e-6)
