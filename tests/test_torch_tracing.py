"""The port's spans and counters (chameleonrt_tpu_torch/core/tracing.py) on
the CPU.

- Off, a span calls nothing in torch: record_function is never entered.
- On, a frame of proc://cornell at 1 spp on one shard holds one `frame`
  span with 5 of each bounce.* span nested in it, and counts 6 host syncs
  (5 nonzero, 1 ray count).
- rays.closest + rays.any is the frame's rays_traced, read with it.
- The image is bit-equal with tracing on and off.
- Two CPU shards with rebalance count their exchange.counts syncs.
- frame_summary's self time leaves out child spans; it sums the frames
  asked for, and the set-up (outside every frame) apart.
- enable(profile_frame=n) runs frame n alone under torch.profiler.
- Off, the module has not imported torch.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core import get_backend, tracing
from chameleonrt_tpu_torch.scene.loader import load_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

CPU = torch.device("cpu")
W, H = 24, 16
BOUNCE_SPANS = ("bounce.sort", "bounce.closest", "bounce.compact", "bounce.shade", "bounce.any")


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.enable(False)
    yield
    tracing.enable(False)


def _backend(devices=0, rebalance=False):
    b = get_backend("cuda", device="cpu", devices=devices, rebalance=rebalance)
    b.initialize(W, H)
    scene = load_scene("proc://cornell")
    b.set_scene(scene)
    b.camera = scene.cameras[0]
    return b


def _frame(b):
    cam = b.camera
    d = (cam.center - cam.position) / np.linalg.norm(cam.center - cam.position)
    return b.render(cam.position, d, cam.up, cam.fov_y, camera_changed=True)


def test_off_calls_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    b = _backend()
    _frame(b)
    assert tracing.span("frame") is tracing.span("bounce.shade") is tracing.sync("frame.rays")
    assert tracing.SPANS == [] and tracing.COUNTS == {}
    tracing.enable(True)
    with pytest.raises(AssertionError, match="crt.frame"):
        _frame(b)


def test_a_traced_frame_nests_its_spans_and_counts_six_syncs():
    b = _backend()
    tracing.enable(True)
    stats = _frame(b)
    spans = [list(s) for s in tracing.SPANS]
    frames = [i for i, s in enumerate(spans) if s[0] == "frame"]
    assert len(frames) == 1

    def under_frame(i):
        while i >= 0:
            if i == frames[0]:
                return True
            i = spans[i][1]
        return False

    for name in BOUNCE_SPANS:
        mine = [i for i, s in enumerate(spans) if s[0] == name]
        assert len(mine) == 5, name
        assert sorted(spans[i][3] for i in mine) == [0, 1, 2, 3, 4], name
        assert all(under_frame(i) for i in mine), name
    # the shading nests in the compaction, the nonzero sync too
    for i, s in enumerate(spans):
        if s[0] in ("bounce.shade", "sync.compact.nonzero"):
            assert spans[s[1]][0] == "bounce.compact" and spans[s[1]][3] == s[3]
    assert all(s[4] <= s[5] for s in spans)
    summary = tracing.frame_summary()
    assert summary["frames"] == 1
    counts = summary["counts"]
    assert counts["host_syncs"] == 6
    assert counts["rays.closest"] + counts["rays.any"] == stats.rays_traced
    assert 0 < counts["lanes.shaded"] <= counts["rays.closest"]
    assert {"frame", "frame.camera", "frame.accumulate", "sync.frame.rays", *BOUNCE_SPANS,
            "bounce.combine", "sync.compact.nonzero"} <= set(summary["host_ms"])
    assert tracing.SPANS == [] and tracing.COUNTS == {}


def test_the_image_is_bit_equal_with_tracing_on_and_off():
    b = _backend()
    off = [_frame(b).rays_traced, b.img.copy(), b.framebuffer().numpy().copy()]
    tracing.enable(True)
    on = [_frame(b).rays_traced, b.img.copy(), b.framebuffer().numpy().copy()]
    assert off[0] == on[0]
    np.testing.assert_array_equal(off[1], on[1])
    np.testing.assert_array_equal(off[2], on[2])


def test_two_shards_count_their_exchange_syncs():
    b = _backend(devices=[CPU, CPU], rebalance=True)
    tracing.enable(True)
    stats = _frame(b)
    names = [s[0] for s in tracing.SPANS]
    summary = tracing.frame_summary()
    # bounces 1-4 exchange, each reading both shards' active counts; each shard's
    # bounce reads its nonzero; one ray count a frame
    assert names.count("sync.exchange.counts") == 4 * 2
    assert names.count("bounce.exchange") == 4
    assert names.count("sync.compact.nonzero") == 5 * 2
    assert summary["counts"]["host_syncs"] == 8 + 10 + 1
    assert summary["counts"]["rays.closest"] + summary["counts"]["rays.any"] == stats.rays_traced


def test_frame_summary_counts_self_time_and_frames():
    tracing.enable(True)
    for _ in range(2):
        with tracing.span("frame"):
            with tracing.span("bounce.shade", 0):
                with tracing.sync("compact.nonzero"):
                    pass
            tracing.count("lanes.shaded", 10)
    spans = list(tracing.SPANS)
    assert [s[0] for s in spans[:3]] == ["frame", "bounce.shade", "sync.compact.nonzero"]
    assert spans[2][3] == 0 and spans[0][3] == -1  # a span takes its parent's bounce
    shade = sum(s[5] - s[4] for s in spans if s[0] == "bounce.shade")
    sync = sum(s[5] - s[4] for s in spans if s[0] == "sync.compact.nonzero")
    summary = tracing.frame_summary()
    assert summary["frames"] == 2
    assert summary["counts"] == {"host_syncs": 1.0, "lanes.shaded": 10.0}
    assert summary["host_ms"]["bounce.shade"] == pytest.approx((shade - sync) / 1e6 / 2)
    assert "Counters, a frame and in all:" in tracing.format_summary(summary)
    with tracing.span("frame"):
        with pytest.raises(RuntimeError):
            tracing.frame_summary()


def test_read_with_reads_the_device_counts_with_the_total():
    tracing.enable(True)
    tracing.count_on_device("rays.any", torch.tensor(3))
    tracing.count_on_device("rays.any", torch.tensor(4))
    assert tracing.read_with(torch.tensor(12)) == 12
    assert tracing.COUNTS == {(0, "rays.any"): 7} and tracing.DEVICE_COUNTS == {}
    tracing.enable(False)
    tracing.count_on_device("rays.any", torch.tensor(3))
    assert tracing.read_with(torch.tensor(5)) == 5 and tracing.DEVICE_COUNTS == {}


def test_frame_summary_sums_the_frames_asked_for_and_the_set_up_apart():
    tracing.enable(True)
    with tracing.span("scene.load"):
        tracing.count("native_builds")
    for _ in range(3):
        with tracing.span("frame"):
            with tracing.sync("frame.rays"):
                pass
    frames = [s[2] for s in tracing.SPANS]
    assert frames == [0, 1, 1, 2, 2, 3, 3]
    own = [s[5] - s[4] for s in tracing.SPANS]
    summary = tracing.frame_summary(frames=[2, 3])
    assert summary["frames"] == 2
    assert summary["setup_ms"] == {"scene.load": pytest.approx(own[0] / 1e6)}
    assert summary["setup_counts"] == {"native_builds": 1}
    assert summary["counts"] == {"host_syncs": 1.0}
    assert summary["host_ms"]["sync.frame.rays"] == pytest.approx((own[4] + own[6]) / 1e6 / 2)
    table = tracing.format_summary(summary)
    assert "Set-up, outside every frame" in table and "(2 frames)" in table


def test_profile_frame_runs_one_frame_under_the_profiler():
    b = _backend()
    tracing.enable(True, profile_frame=2)
    for _ in range(3):
        _frame(b)
    assert len(tracing.PROFILE) == 1
    names = [e.name for e in tracing.PROFILE[0].events()]
    assert names.count("crt.frame") == 1 and names.count("crt.bounce.shade") == 5
    assert any(n.startswith("aten::") for n in names)
    tracing.enable(False)
    assert len(tracing.PROFILE) == 1
    tracing.enable(True)
    assert tracing.PROFILE == []


def test_off_the_module_imports_no_torch():
    code = ("import sys; from chameleonrt_tpu_torch.core import tracing; "
            "[tracing.span('x'), tracing.sync('y'), tracing.count('z'), tracing.read_with(5)]; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]
