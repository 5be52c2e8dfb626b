"""traversal_device_ms: device milliseconds a profiled frame of the
traversal kernels, matched by name (layer: traversal)."""

from benchmark.harness.trace import TRAVERSAL_KERNEL


def read(record):
    us = [e - s for name, s, e in record.get("device_events") or [] if TRAVERSAL_KERNEL.search(name)]
    return sum(us) / 1e3 / record["frames"] if us else None
