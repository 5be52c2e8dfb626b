"""A cell added as data alone: a cell file, a traffic mix and BENCHMARK.json
entries dropped into a copy of the benchmark run with no code edited."""

import json
import os
import time

from benchmark.harness import bench, spec
from benchmark.tests import tiny


def test_a_dropped_in_cell_runs(tmp_path):
    bench_dir = tiny.make_copy(str(tmp_path), [("new-cell", "cornell_box")], width=32, height=20)
    with open(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")) as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    assert "new-cell" in names
    cell = spec.load_cell("new-cell", bench_dir)
    assert (cell.traffic["width"], cell.traffic["height"]) == (32, 20)
    result, rows = bench.run_cell(cell, 17, 0.5, False, time.perf_counter(), device="cpu")
    assert result["correct"], rows
    assert {"frame_ms", "mrays_per_s", "setup_s"} <= set(result["metrics"])
