"""The span metrics (harness/spans.py, metrics/sort_device_ms.py and the
five beside it) on synthetic records: kernels charged to the span that held
their launch, idle gaps to the span open when they opened, user
annotations ignored; the launch of each device event found through its
correlation ids; a span run of a tiny cell on the CPU, through
bench.run_cell and its reference; and no reading, without a raise, where
the program has no spans, no bench.run_cell call is reading, or the span
run is not correct."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.harness import bench, spans, spec
from benchmark.tests import tiny
from chameleonrt_tpu_torch.core import tracing

SPAN_METRICS = ("sort_device_ms", "compact_device_ms", "shade_device_ms", "sync_idle_ms",
                "host_syncs_per_frame", "shade_host_ms")

# host spans and device events of one frame, in us
HOST = [("frame", 0.0, 1000.0), ("bounce.sort", 10.0, 100.0), ("bounce.closest", 100.0, 150.0),
        ("bounce.compact", 150.0, 600.0), ("sync.compact.nonzero", 160.0, 300.0),
        ("bounce.shade", 300.0, 550.0), ("sync.frame.rays", 700.0, 990.0)]
DEVICE = [
    ("crt.frame", 0.0, 1000.0, None, True),  # the spans' own device ranges: no work, no busy time
    ("crt.bounce.shade", 320.0, 420.0, None, True),
    ("void at::native::radix_sort_kernel", 20.0, 60.0, 15.0, False),  # sort, 40
    ("void closest_kernel<64>(Params)", 110.0, 140.0, 105.0, False),  # closest, 30
    ("void at::native::nonzero_kernel", 170.0, 180.0, 165.0, False),  # the nonzero sync, 10
    ("Memcpy DtoH (Device -> Pinned)", 180.0, 182.0, 170.0, False),  # busy, no kernel
    # idle 182 -> 320 opens inside sync.compact.nonzero: 138
    ("void at::native::elementwise_kernel", 320.0, 420.0, 310.0, False),  # shade, 100
    ("void at::native::index_put_kernel", 560.0, 580.0, 555.0, False),  # compact itself, 20
    # idle 580 -> 800 opens inside bounce.compact
    ("void at::native::reduce_kernel", 800.0, 810.0, 620.0, False),  # combine ... frame, 10
    # idle 810 -> 900 opens inside sync.frame.rays: 90
    ("void at::native::unrolled_elementwise_kernel", 900.0, 905.0, None, False),  # no launch found
]


def _record(frames=1):
    return {"spans": {"span_host": HOST, "span_device": DEVICE, "span_frames": frames,
                      "span_host_ms": {"frame": 2.0, "bounce.shade": 1.25},
                      "counts": {"host_syncs": 6.0, "rays.closest": 30.0, "rays.any": 12.0}}}


def test_span_readers_on_a_synthetic_record():
    rec = _record()

    def read(name):
        return spec.metric_reader(name)(rec)

    assert read("sort_device_ms") == pytest.approx(0.040)
    assert read("compact_device_ms") == pytest.approx(0.010 + 0.020)
    assert read("shade_device_ms") == pytest.approx(0.100)
    assert read("sync_idle_ms") == pytest.approx(0.138 + 0.090)
    assert read("host_syncs_per_frame") == 6.0
    assert read("shade_host_ms") == 1.25
    charges = rec["spans"]
    assert charges["device_ms"]["frame"] == pytest.approx(0.010)
    assert charges["device_ms"][spans.NO_SPAN] == pytest.approx(0.005)
    assert charges["kernels"] == {"bounce.sort": 1.0, "bounce.closest": 1.0, "sync.compact.nonzero": 1.0,
                                  "bounce.shade": 1.0, "bounce.compact": 1.0, "frame": 1.0,
                                  spans.NO_SPAN: 1.0}
    # every gap: 60-110 in the sort, 140-170 in closest, 420-560 in shade, 580-800 in compact
    assert charges["idle_ms"] == pytest.approx({
        "bounce.sort": 0.050, "bounce.closest": 0.030, "sync.compact.nonzero": 0.138,
        "bounce.shade": 0.140, "bounce.compact": 0.220, "sync.frame.rays": 0.090})


def test_span_readers_average_over_the_frames():
    assert spec.metric_reader("shade_device_ms")(_record(frames=2)) == pytest.approx(0.050)


def test_launches_are_found_by_correlation_id():
    def ev(name, dev, start, end, id, linked=0, annotation=False):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=start, end=end),
                               id=id, linked_correlation_id=linked, is_user_annotation=annotation)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    host, device = spans.spans_and_launches([
        ev("crt.bounce.closest", cpu, 0, 100, 3),
        ev("aten::mul", cpu, 10, 20, 7),
        ev("cudaLaunchKernel", cpu, 12, 14, 7, linked=7),  # the runtime call shares its kernel's id
        ev("void at::native::mul_kernel", cuda, 50, 60, 7, linked=7),
        ev("void closest_kernel<64>", cuda, 60, 90, 11, linked=3),  # no runtime call seen: its span
        ev("void at::native::fill_kernel", cuda, 90, 95, 12),  # nothing to link to
        ev("crt.bounce.closest", cuda, 50, 90, 0, annotation=True),
    ])
    assert host == [("bounce.closest", 0.0, 100.0)]
    assert device == [("void at::native::mul_kernel", 50.0, 60.0, 12.0, False),
                      ("void closest_kernel<64>", 60.0, 90.0, 0.0, False),
                      ("void at::native::fill_kernel", 90.0, 95.0, None, False),
                      ("crt.bounce.closest", 50.0, 90.0, None, True)]


def test_no_spans_no_reading(monkeypatch):
    for name in SPAN_METRICS:  # read outside a bench.run_cell call
        assert spec.metric_reader(name)({"frames": 1, "wall_s": 1.0}) is None
    monkeypatch.setattr(spans, "_running_cell", lambda: (None, 5, "cpu"))
    monkeypatch.setattr(spans, "program_tracing", lambda: None)  # a program without spans
    rec = {"frames": 1, "wall_s": 1.0}
    for name in SPAN_METRICS:
        assert spec.metric_reader(name)(rec) is None
    assert rec["spans"] is None


def _tiny_cell(tmp_path):
    bench_dir = tiny.make_copy(str(tmp_path), [("span-cell", "cornell_box")], width=32, height=20)
    return spec.load_cell("span-cell", bench_dir)


def test_a_span_run_on_the_cpu(tmp_path, monkeypatch):
    """The span run is a whole bench.run_cell with the spans on, checked by
    the reference; on the CPU its span frame holds host spans and no device
    events, so the device metrics read nothing."""
    cell = _tiny_cell(tmp_path)
    monkeypatch.setattr(spans, "_running_cell", lambda: (cell, 2**31 + 7, "cpu"))
    rec = {"frames": 1, "wall_s": 0.5, "closest_share": 0.6}
    assert spec.metric_reader("host_syncs_per_frame")(rec) == 6.0
    assert spec.metric_reader("shade_host_ms")(rec) > 0
    for name in ("sort_device_ms", "compact_device_ms", "shade_device_ms", "sync_idle_ms"):
        assert spec.metric_reader(name)(rec) is None
    got = rec["spans"]
    assert [name for name, _, _ in got["span_host"]].count("frame") == 1
    assert [name for name, _, _ in got["span_host"]].count("bounce.shade") == 5
    assert got["span_device"] == [] and got["device_ms"] == {}
    assert got["counts"]["rays.closest"] > 0 and not tracing.enabled()


def test_an_incorrect_or_failed_span_run_gives_no_reading(tmp_path, monkeypatch):
    cell = _tiny_cell(tmp_path)
    monkeypatch.setattr(spans, "_running_cell", lambda: (cell, 11, "cpu"))
    run_cell = bench.run_cell

    def wrong(*args):
        result, rows = run_cell(*args)
        return dict(result, correct=False), rows

    monkeypatch.setattr(bench, "run_cell", wrong)
    rec = {"frames": 1, "wall_s": 0.2}
    assert spec.metric_reader("host_syncs_per_frame")(rec) is None and rec["spans"] is None

    def raises(*args):
        raise RuntimeError("no card")

    monkeypatch.setattr(bench, "run_cell", raises)  # a span run that raises: no reading, no raise
    rec = {"frames": 1, "wall_s": 0.2}
    assert spec.metric_reader("shade_host_ms")(rec) is None and rec["spans"] is None
    assert not tracing.enabled()
