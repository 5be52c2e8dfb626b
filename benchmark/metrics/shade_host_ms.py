"""shade_host_ms: host milliseconds a frame of the program's bounce.shade
spans' self time, without a profiler: the host's issue of the shading
ops (layer: shading ops; harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    return spans["span_host_ms"].get("bounce.shade") if spans else None
