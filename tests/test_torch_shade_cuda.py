"""S1, the shading kernel (csrc/shade.cu, ops/shade_cuda.py), on the card.

Marked `card`: each test takes the `card` fixture, which skips it where
torch sees no CUDA card. The card's host has no JAX, which tests/conftest.py
imports, so there the file runs without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shade_cuda.py

  - S1 against the plain shading (ops/shade_cuda.py's _shade_bounce,
    torch's CUDA ops) on the same CUDA lanes: every shading call of a frame
    of each of tests/shade_scenes.py's scenes. Both sides are built with
    -fmad=false and call CUDA's own math functions, so every field should
    be bit-equal; the test asks for the RNG state and the masks equal on
    every lane and the float fields bit-equal on at least 99.9% of lanes
    and within 1e-5, relative or absolute, on all.
  - A whole 960x960 Cornell frame through the cuda backend against the
    same frame with the plain shading put in S1's place by the test: rays
    traced equal, sRGB8 images equal but for at most 0.01% of pixels, by
    one level.
  - S1 launches 5 times a frame a sample, and, traced, shades every live
    lane (lanes.shaded_kernel equals lanes.shaded).
  - N shards of the textured hall on one card give the one device's image.
"""

import numpy as np
import pytest
import torch

from shade_scenes import SCENES, frame_lanes

from chameleonrt_tpu_torch.core import get_backend, tracing
from chameleonrt_tpu_torch.ops import shade_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene

pytestmark = pytest.mark.card

W, H = 320, 320
FLOATS = ("c1", "c2", "light_dir", "light_dist", "w_i2", "t_light", "new_throughput", "cont_dir")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _view(scene):
    cam = scene.cameras[0]
    d = cam.center - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


@pytest.mark.parametrize("name", sorted(SCENES))
def test_s1_matches_the_plain_shading(card, name):
    calls = frame_lanes(SCENES[name](), W, H, card)
    assert [c[2] for c in calls] == list(range(5))
    for flat, meta, bounce, lanes in calls:
        R = lanes[0].shape[0]
        want = shade_cuda._shade_bounce(flat, meta, bounce, *lanes)
        got = shade_cuda.shade_bounce(flat, meta, bounce, *lanes)
        torch.cuda.synchronize()
        assert torch.equal(got.state, want.state), (name, bounce)
        for field in ("shoot1", "shoot2", "new_active"):
            assert torch.equal(getattr(got, field), getattr(want, field)), (name, bounce, field)
        for field in FLOATS:
            a, w = getattr(got, field).reshape(R, -1), getattr(want, field).reshape(R, -1)
            # equal, or NaN on both sides; a NaN on one side only is an
            # error of NaN, which no limit admits
            same = (a == w) | (a.isnan() & w.isnan())
            differ = (~same).any(1)
            err = torch.where(same, 0.0, (a - w).abs() / w.abs().clamp(min=1.0))
            assert int(differ.sum()) <= 1e-3 * R, (name, bounce, field, int(differ.sum()), R)
            assert not bool(err.isnan().any()), (name, bounce, field)
            assert not R or float(err.max()) <= 1e-5, (name, bounce, field, float(err.max()))


def _cornell_frame(card, spp=1):
    """One 960x960 frame of the Cornell Box through the cuda backend:
    (RenderStats, the sRGB8 image)."""
    scene = load_scene("proc://cornell")
    b = get_backend("cuda", device=card)
    b.initialize(960, 960)
    b.set_scene(scene)
    b.samples_per_pixel = spp
    stats = b.render(*_view(scene), True)
    return stats, b.img[..., :3].copy()


def test_a_frame_through_s1_is_the_plain_shadings_frame(card, monkeypatch):
    stats, img = _cornell_frame(card)
    monkeypatch.setattr(shade_cuda, "shade_bounce", shade_cuda._shade_bounce)
    plain_stats, plain_img = _cornell_frame(card)
    assert stats.rays_traced == plain_stats.rays_traced
    diff = np.abs(img.astype(np.int16) - plain_img.astype(np.int16)).max(-1)
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 1e-4 * diff.size, (
        int(diff.max()), int((diff > 0).sum()))


def test_s1_shades_every_live_lane(card):
    before = shade_cuda.LAUNCHES
    tracing.enable(True)
    try:
        _cornell_frame(card, spp=2)
    finally:
        tracing.enable(False)
    counts = tracing.frame_summary()["counts"]
    assert shade_cuda.LAUNCHES - before == 5 * 2
    assert counts["lanes.shaded_kernel"] == counts["lanes.shaded"] > 0


@pytest.mark.parametrize("n", [3, 4])
def test_shards_on_one_card_give_the_one_devices_image(card, n):
    scene = load_scene("proc://hall?subdiv=1&textured=1")
    out = []
    for devices in (0, [card] * n):
        b = get_backend("cuda", devices=devices, rebalance=True)
        b.initialize(320, 180)
        b.set_scene(scene)
        frames = [b.render(*_view(scene), i == 0) for i in range(2)]
        out.append(([f.rays_traced for f in frames], b.img.copy()))
    (rays, img), (shard_rays, shard_img) = out
    assert rays == shard_rays
    assert np.array_equal(img, shard_img)
