"""torch_ops_device_ms: device milliseconds a profiled frame of every
kernel that is not a traversal kernel (layer: shading ops, with the path
loop's sort and compaction)."""

from benchmark.harness.trace import TRAVERSAL_KERNEL, is_transfer


def read(record):
    events = record.get("device_events") or []
    us = [e - s for name, s, e in events if not is_transfer(name) and not TRAVERSAL_KERNEL.search(name)]
    return sum(us) / 1e3 / record["frames"] if us else None
