"""compact_device_ms: device milliseconds a frame of the kernels launched
inside the program's bounce.compact spans but outside bounce.shade: the
live lanes' nonzero (its sync.compact.nonzero span), gathers and
scatter-back (layer: path loop; harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    if not spans:
        return None
    parts = [spans["device_ms"][k] for k in ("bounce.compact", "sync.compact.nonzero")
             if k in spans["device_ms"]]
    return sum(parts) if parts else None
