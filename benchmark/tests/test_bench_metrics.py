"""The metric arithmetic on synthetic records: the window's rates, the p90
over all frames, the interval union, the roofline bytes and each per-layer
reader."""

import pytest

from benchmark.harness import bench, roofline, spec, trace


def test_window_values():
    times = [0.2] * 90 + [0.3] * 9 + [1.0]
    v = bench.window_values(times, rays=5_000_000, wall=25.0, setup_s=12.5)
    assert v["frame_ms"] == pytest.approx(250.0)
    assert v["mrays_per_s"] == pytest.approx(0.2)
    assert v["setup_s"] == 12.5
    assert v["frame_ms_p90"] == pytest.approx(200.0)  # the 90th of 100 by nearest rank
    assert bench.p90([0.2] * 89 + [0.3] * 11) == 0.3


def test_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.union_us([]) == 0


def test_roofline_bytes():
    assert roofline.least_bytes(1, 0, False) == 33 + 16
    assert roofline.least_bytes(1, 0, True) == 33 + 20
    assert roofline.least_bytes(0, 1, False) == 33 + 1
    assert roofline.least_seconds(3.35e12 / 49, 0, False, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)


RECORD = {
    "scene_load_s": 0.5, "set_scene_s": 0.4, "frames": 2, "wall_s": 0.5, "rays": 1_000_000,
    "closest_share": 0.4, "card": "NVIDIA H100 80GB HBM3",
    "device_events": [
        ("void closest_kernel<64>(Params)", 0.0, 1000.0),
        ("void any_kernel<64>(Params)", 1000.0, 2000.0),
        ("void at::native::vectorized_elementwise_kernel<4>", 3000.0, 103000.0),
        ("Memcpy DtoH (Device -> Pinned)", 200000.0, 200010.0),
    ],
}


def test_readers_on_a_synthetic_record():
    def read(name):
        return spec.metric_reader(name)(RECORD)

    assert read("scene_load_s") == 0.5 and read("set_scene_s") == 0.4
    assert read("kernels_per_frame") == 1.5
    assert read("traversal_device_ms") == pytest.approx(1.0)
    assert read("torch_ops_device_ms") == pytest.approx(50.0)
    busy = 2000.0 + 100000.0 + 10.0
    assert read("device_idle_share") == pytest.approx(100.0 * (1 - busy * 1e-6 / 0.5))
    least = (400_000 * 49 + 600_000 * 34) / 3.35e12
    assert read("traversal_roofline") == pytest.approx(100.0 * least / 2e-3)


def test_two_level_kernels_count_the_instance_out():
    rec = dict(RECORD, device_events=[("closest_unified_kernel<64>", 0.0, 1000.0)])
    least = (400_000 * 53 + 600_000 * 34) / 3.35e12
    assert spec.metric_reader("traversal_roofline")(rec) == pytest.approx(100.0 * least / 1e-3)


def test_readers_find_nothing_and_say_so():
    empty = {"frames": 1, "wall_s": 1.0, "device_events": []}
    for name in ("kernels_per_frame", "torch_ops_device_ms", "traversal_device_ms",
                 "traversal_roofline", "device_idle_share"):
        assert spec.metric_reader(name)(empty) is None


def test_a_dotted_name_reads_as_its_base():
    assert spec.base_name("device_idle_share.device_paced") == "device_idle_share"
    assert spec.metric_reader("device_idle_share.device_paced")(RECORD) == \
        spec.metric_reader("device_idle_share")(RECORD)
    values = bench.window_values([0.5, 0.5], rays=10, wall=1.0, setup_s=1.0)
    assert values[spec.base_name("frame_ms.device_paced")] == pytest.approx(500.0)
