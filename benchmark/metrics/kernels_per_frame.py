"""kernels_per_frame: device kernel events a profiled frame, memcpy and
memset left out (layer: path loop). The profiler may miss events; PERF.md
gives its miss rate."""

from benchmark.harness.trace import is_transfer


def read(record):
    events = record.get("device_events") or []
    n = sum(1 for name, _, _ in events if not is_transfer(name))
    return n / record["frames"] if n else None
