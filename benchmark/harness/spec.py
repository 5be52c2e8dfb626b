"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root,
and under the benchmark's directory cells/<cell>.json, traffic/<mix>.json,
configs/<config>.json with its generator configs/<generator>.py, and
metrics/<metric>.py. Adding a cell, a traffic mix, a configuration or a
per-layer metric is adding files and BENCHMARK.json entries. A metric
named `<name>.<cells>` is `<name>` reported in other cells under an entry
(and a bound) of its own."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one run of a cell reads."""

    name: str
    workload: dict  # its BENCHMARK.json entry
    cell: dict  # cells/<name>.json
    traffic: dict  # traffic/<mix>.json
    config: dict  # configs/<config>.json
    bench: dict  # BENCHMARK.json
    bench_dir: str

    def generator(self):
        """The configuration's scene generator module."""
        gen = self.config["generator"]
        return _module(os.path.join(self.bench_dir, "configs", gen + ".py"), f"bench_config_{gen}")

    def end_to_end(self):
        """This cell's end-to-end metrics (entries of BENCHMARK.json)."""
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_dir: str = BENCH_DIR) -> Cell:
    bench = _json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = entries[0]
    cell = _json(os.path.join(bench_dir, "cells", name + ".json"))
    if cell["config"] != wl["config"] or cell["traffic"] != wl["traffic"]:
        raise SystemExit(f"cells/{name}.json names another config or traffic than BENCHMARK.json")
    return Cell(name=name, workload=wl, cell=cell,
                traffic=_json(os.path.join(bench_dir, "traffic", wl["traffic"] + ".json")),
                config=_json(os.path.join(bench_dir, "configs", wl["config"] + ".json")),
                bench=bench, bench_dir=bench_dir)


def base_name(name: str) -> str:
    """A metric's name before its first dot: `frame_ms.device_paced` is
    `frame_ms` read in other cells, under a bound of its own."""
    return name.split(".")[0]


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """read(record) -> float or None of metrics/<name>.py, or, where there is
    no such file, of metrics/<base_name(name)>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.isfile(path):
        name = base_name(name)
        path = os.path.join(bench_dir, "metrics", name + ".py")
    return _module(path, f"bench_metric_{name}").read
