"""BENCHMARK.json against the benchmark's contract, and every cell, traffic
mix, configuration and per-layer metric found by name."""

import json
import os
import re

import pytest

from benchmark.harness import check, spec

ROOT = os.path.dirname(spec.BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["chips"] == 1


def test_metrics_sources_bounds_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["per_layer"]:  # each cell a per-layer metric lists reports the metric it moves
        moves = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moves.get("workloads", cells)), m["name"]
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        reported = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert {"width", "height", "spp"} <= set(cell.traffic)
    assert {"srgb_mad", "srgb_bad_px"} <= set(cell.cell["limits"]) <= set(check.NAMES)
    assert callable(cell.generator().generate)
    for m in cell.per_layer():
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_names_its_source(name):
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as f:
        cfg = json.load(f)
    entry = [c for c in BENCH["configs"] if c["name"] == name][0]
    assert cfg["name"] == name and cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["published"])
    assert all(cfg[k] != cfg["published"][k] for k in cfg["reduced"])
