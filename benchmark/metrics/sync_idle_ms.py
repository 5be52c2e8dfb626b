"""sync_idle_ms: device idle milliseconds a frame whose gap opened while
the host was inside one of the program's sync spans, a blocking
device-to-host read: the bubble while the host waits and then refills the
queue (layer: path loop; harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    if not spans or not spans["span_device"]:
        return None
    return sum((ms for name, ms in spans["idle_ms"].items() if name.startswith("sync.")), 0.0)
