"""sort_device_ms: device milliseconds a frame of the kernels launched
inside the program's bounce.sort spans: the wavefront's stable re-sort
and its gathers (layer: path loop; harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    return spans["device_ms"].get("bounce.sort") if spans else None
