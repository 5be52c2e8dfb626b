"""The cell this benchmark's second configuration brought: it loads by
name with its configuration, traffic and generator, and the shading
kernel's roofline share reads the known value off a synthetic record."""

import pytest

from benchmark.harness import spec

CELLS = {"rtiow-1200x800-10spp": ("rtiow_final", (1200, 800, 10))}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_new_cells_load_by_name(name):
    cell = spec.load_cell(name)
    config, size = CELLS[name]
    assert cell.config["name"] == config and cell.workload["chips"] == 1
    assert (cell.traffic["width"], cell.traffic["height"], cell.traffic["spp"]) == size
    assert cell.traffic["camera"] == "static" and callable(cell.generator().generate)
    assert {m["name"] for m in cell.end_to_end()} >= {"setup_s"} and len(cell.end_to_end()) >= 2
    assert cell.per_layer() and all(callable(spec.metric_reader(m["name"])) for m in cell.per_layer())


def test_the_rtiow_cell_reports_its_five_metrics():
    names = {m["name"] for m in spec.load_cell("rtiow-1200x800-10spp").per_layer()}
    assert {"traversal_device_ms.rtiow", "traversal_roofline.rtiow", "shade_device_ms.rtiow",
            "device_idle_share.rtiow", "shade_roofline"} <= names


def test_shade_roofline_reads_the_known_value():
    read = spec.metric_reader("shade_roofline")
    # 10M lanes a frame at 152 bytes (57 in, 4 of instance, 91 out) over 3.35 TB/s: 0.4537 ms
    record = {"card": "NVIDIA H100 80GB HBM3",
              "spans": {"device_ms": {"bounce.shade": 2.0}, "counts": {"lanes.shaded": 1.0e7}}}
    assert read(record) == pytest.approx(100.0 * 1.52e9 / 3.35e12 / 2.0e-3)
    assert read({"spans": None}) is None
    assert read({"spans": {"device_ms": {}, "counts": {"lanes.shaded": 5.0}}}) is None
