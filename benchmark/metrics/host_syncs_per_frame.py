"""host_syncs_per_frame: the program's host_syncs counter a frame, one
for each blocking device-to-host read (layer: path loop;
harness/spans.py)."""

from benchmark.harness.spans import span_record


def read(record):
    spans = span_record(record)
    return spans["counts"].get("host_syncs") if spans else None
