"""The harness without its look for a card, driving a whole run on the
CPU with the program's timed path broken underneath: `correct` has to come
out false for each fault a cell of this benchmark can have. (One chip a
cell: there is no exchange between chips to leave out.)"""

import time

import pytest
import torch

from benchmark.harness import bench, spec
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")), [("f-cornell", "cornell_box")])


def _state_unchanged(monkeypatch):
    """A frame that returns the accumulation as it found it."""
    from chameleonrt_tpu_torch.engine import path_tracer

    monkeypatch.setattr(path_tracer, "progressive_accum", lambda accum, illum, frame_id: accum)


def _half_the_batch(monkeypatch):
    """Half of the pixels traced, each other pixel given its traced
    neighbour's value: the mean of the half that was rendered."""
    from chameleonrt_tpu_torch.engine import path_tracer

    real = path_tracer.render_pixels

    def half(flat, meta, tc, ta, view, frame_id, px, py, W, H, spp, *args, **kw):
        illum, rays = real(flat, meta, tc, ta, view, frame_id, px[::2], py[::2], W, H, spp, *args, **kw)
        return illum.repeat_interleave(2, dim=0)[: px.shape[0]], rays * 2

    monkeypatch.setattr(path_tracer, "render_pixels", half)


def _answer_altered(monkeypatch):
    """Where the illumination is produced, one pixel in 8 comes out
    brighter by a quarter of the light of a white surface."""
    from chameleonrt_tpu_torch.engine import path_tracer

    real = path_tracer.render_pixels

    def altered(*args, **kw):
        illum, rays = real(*args, **kw)
        illum = illum.clone()
        illum[::8] += 0.25
        return illum, rays

    monkeypatch.setattr(path_tracer, "render_pixels", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    cell = spec.load_cell("f-cornell", tiny_bench)
    result, rows = bench.run_cell(cell, 424242, 0.5, False, time.perf_counter(), device="cpu")
    assert not result["correct"], rows


def test_the_same_run_unbroken_is_correct(tiny_bench):
    cell = spec.load_cell("f-cornell", tiny_bench)
    result, rows = bench.run_cell(cell, 424242, 0.5, False, time.perf_counter(), device="cpu")
    assert result["correct"], rows
    assert torch.isfinite(torch.tensor([r[1] for r in rows])).all()
