"""At a tiny size on the CPU: the reference agrees with the program, run
through the whole harness, and the lower-precision control (the reference
with its per-lane state in bfloat16, put in the program's place) fails the
same numbers."""

import time

import pytest

from benchmark import readings
from benchmark.harness import bench, check, spec
from benchmark.tests import tiny

CELLS = [("t-cornell", "cornell_box")]


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")), CELLS)


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_reference_agrees_with_the_program(tiny_bench, name):
    cell = spec.load_cell(name, tiny_bench)
    result, rows = bench.run_cell(cell, 2**31 + 99, 1.0, False, time.perf_counter(), device="cpu")
    assert result["correct"], rows
    assert result["failed"] == 0 and result["attempted"] >= 1
    # a tiny cell is listed under every metric: the .device_paced ones read as their base
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p90", "mrays_per_s", "frame_ms.device_paced",
                                      "mrays_per_s.device_paced", "setup_s"}
    m = result["metrics"]
    assert m["frame_ms"]["value"] == m["frame_ms.device_paced"]["value"]
    assert result["checks"]["frame_rays_gap"]["value"] == 0.0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_lower_precision_control_fails(tiny_bench, name):
    cell = spec.load_cell(name, tiny_bench)
    for seed in (3, 4):
        values = readings.control_readings(cell, seed, frames=4, device="cpu")
        correct, rows = check.judge(values, cell.cell["limits"])
        assert not correct, rows
