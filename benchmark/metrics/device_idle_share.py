"""device_idle_share: the share (%) of the profiled frames' wall time in
which no operation ran on the device: 1 - (union of the device events'
intervals) / (host time of the same frames) (layer: device)."""

from benchmark.harness.trace import union_us


def read(record):
    events = record.get("device_events") or []
    if not events or not record.get("wall_s"):
        return None
    return 100.0 * (1.0 - union_us([(s, e) for _, s, e in events]) * 1e-6 / record["wall_s"])
