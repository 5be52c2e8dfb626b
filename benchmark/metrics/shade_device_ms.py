"""shade_device_ms: device milliseconds a frame of the kernels launched
inside the program's bounce.shade spans: the shading of the live lanes
(layer: shading ops; harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    return spans["device_ms"].get("bounce.shade") if spans else None
