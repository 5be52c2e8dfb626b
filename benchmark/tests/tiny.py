"""A copy of the benchmark in a temporary directory whose configurations
are cut to sizes a CPU test holds, with cells of its own added as data
files and BENCHMARK.json entries: no code is edited."""

from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# keys of each configuration changed for the CPU (the Cornell Box is small as published)
TINY_CONFIGS = {"cornell_box": {}}
# each configuration's limits as its first cell states them
LIMIT_CELLS = {"cornell_box": "cornell-960-1spp"}


def make_copy(root: str, cells, width: int = 40, height: int = 24, spp: int = 1) -> str:
    """Copy the benchmark under root, cut its configurations, and add one
    cell per (name, config) in cells on a traffic mix `tiny`. Returns the
    copy's benchmark directory."""
    bench_dir = os.path.join(root, "benchmark")
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    for cfg, over in TINY_CONFIGS.items():
        path = os.path.join(bench_dir, "configs", cfg + ".json")
        with open(path) as f:
            c = json.load(f)
        c.update(over)
        with open(path, "w") as f:
            json.dump(c, f)
    with open(os.path.join(bench_dir, "traffic", "tiny.json"), "w") as f:
        json.dump({"width": width, "height": height, "spp": spp, "camera": "static"}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cfg in cells:
        with open(os.path.join(bench_dir, "cells", LIMIT_CELLS[cfg] + ".json")) as f:
            limits = json.load(f)["limits"]
        with open(os.path.join(bench_dir, "cells", name + ".json"), "w") as f:
            json.dump({"config": cfg, "traffic": "tiny", "chips": 1, "why": "a CPU test",
                       "profile_frames": 1, "reference_lanes": 4000, "min_pixels": 64,
                       "max_pixels": width * height, "limits": limits}, f)
        bench["workloads"].append({"name": name, "config": cfg, "traffic": "tiny", "chips": 1,
                                   "why": "a CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench_dir
