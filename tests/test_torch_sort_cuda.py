"""R1-R3, the re-sort's kernels (csrc/sort.cu, ops/sort_cuda.py), on the card.

Marked `card`: each test takes the `card` fixture (or the `waves` fixture,
which asks for it), which skips it where torch sees no CUDA card. The
card's host has no JAX, which tests/conftest.py imports, so there the file
runs without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sort_cuda.py

  - On CUDA wavefronts, the kernel path against the plain path (torch's
    CUDA ops): R1's bounds equal the origins' min and max, R2's int32 key
    equals ray_sort_key on every lane, the stable sort of it gives
    ray_sort_perm_only's permutation, and every one of the seven sorted
    fields is bit-equal to the plain re-sort's. The wavefronts: a 2880x2880
    Cornell Box frame's primary wavefront and its bounce-2 wavefront (dead
    lanes mixed in), and a bounce-2 wavefront of the benchmark's rtiow_final
    scene at 1200x800; then every lane dead, one lane, every origin equal,
    many equal keys (stability) and a NaN origin.
  - A traced 960x960 Cornell frame at 2 spp launches R1-R3 3 times a bounce
    and sorts every lane of every bounce through them (lanes.sorted_kernel
    = 5 x R x spp).
  - 2 shards on one card, rebalanced, give the one device's image.
"""

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch.core import get_backend, tracing
from chameleonrt_tpu_torch.ops import sort_cuda
from chameleonrt_tpu_torch.ops.traverse import ray_sort_key, ray_sort_perm_only
from chameleonrt_tpu_torch.scene.loader import load_scene

pytestmark = pytest.mark.card

RTIOW_CELL = "rtiow-1200x800-10spp"
RTIOW_SEED = 2**31 + 2201


def _has_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def card():
    return _has_card()


def _view(scene):
    cam = scene.cameras[0]
    d = cam.center - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


def _captured(render, calls):
    """Run render() with sort_cuda.sort_wavefront wrapped; return clones of
    the wavefronts of the given call indices (bounces, at 1 spp)."""
    sort = sort_cuda.sort_wavefront
    seen, out = [0], {}

    def capture(*wave):
        if seen[0] in calls:
            out[seen[0]] = tuple(x.clone() for x in wave)
        seen[0] += 1
        return sort(*wave)

    sort_cuda.sort_wavefront = capture
    try:
        render()
    finally:
        sort_cuda.sort_wavefront = sort
    return out


def _cornell_waves(dev):
    scene = load_scene("proc://cornell")
    b = get_backend("cuda", device=dev)
    b.initialize(2880, 2880)
    b.set_scene(scene)
    b.samples_per_pixel = 1
    got = _captured(lambda: b.render(*_view(scene), True, readback_framebuffer=False), (0, 2))
    return {"cornell2880_primary": got[0], "cornell2880_bounce2": got[2]}


def _rtiow_wave(dev, tmp):
    from benchmark.harness import bench, spec

    cell = spec.load_cell(RTIOW_CELL)
    camera = bench.camera_for(cell.config, RTIOW_SEED)
    path, _ = cell.generator().generate(str(tmp), RTIOW_SEED, cell.config, camera)
    b = get_backend("cuda", device=dev)
    b.initialize(1200, 800)
    b.set_scene(load_scene(path))
    b.samples_per_pixel = 1
    got = _captured(lambda: b.render(*bench.view_of(camera), True, readback_framebuffer=False),
                    (2,))
    return {"rtiow_bounce2": got[2]}


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    dev = _has_card()
    out = {**_cornell_waves(dev), **_rtiow_wave(dev, tmp_path_factory.mktemp("rtiow"))}
    torch.cuda.synchronize()
    return out


def _edge(name, dev):
    """A wavefront of an edge case, on dev."""
    rng = np.random.default_rng(7)
    R = {"one_lane": 1}.get(name, 100_003)
    orig = rng.normal(size=(R, 3)).astype(np.float32) * np.float32(3.0)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    active = rng.random(R) < 0.6
    if name == "all_dead":
        active[:] = False
    elif name == "equal_origins":
        orig[:] = orig[0]
    elif name == "equal_keys":  # 3 points, 2 octants: nearly every key is tied
        orig = orig[rng.integers(0, 3, R)]
        d = np.abs(d) * np.where(rng.random((R, 1)) < 0.5, 1.0, -1.0).astype(np.float32)
    elif name == "nan_origin":
        orig[R // 2, 1] = np.nan
    fields = (rng.integers(0, 2**32, R, dtype=np.int64), orig, d,
              rng.random((R, 3), dtype=np.float32), rng.random((R, 3), dtype=np.float32),
              active, rng.permutation(R).astype(np.int64))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in fields)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _check_wave(wave):
    orig, dir, active = wave[1], wave[2], wave[5]
    R = orig.shape[0]
    lohi = sort_cuda.bounds(orig)
    want = torch.cat([orig.min(0).values, orig.max(0).values])
    assert torch.equal(lohi.isnan(), want.isnan()), (lohi, want)
    assert bool(((lohi == want) | want.isnan()).all()), (lohi, want)
    key = sort_cuda.keys(orig, dir, active, lohi)
    want_key = ray_sort_key(orig, dir, active)
    assert key.dtype == torch.int32
    differ = int((key.long() != want_key).sum())
    assert differ == 0, f"{differ} of {R} keys differ"
    perm = torch.sort(key, stable=True).indices
    want_perm = ray_sort_perm_only(orig, dir, active)
    assert torch.equal(perm, want_perm), int((perm != want_perm).sum())
    got = sort_cuda.sort_wavefront(*wave)
    want = sort_cuda.sort_wavefront_plain(*wave)
    torch.cuda.synchronize()
    for (name, _, _), g, w in zip(sort_cuda.FIELDS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = (_bits(g) != _bits(w)).reshape(R, -1).any(1)
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} of {R} lanes differ"


@pytest.mark.parametrize("name", ["cornell2880_primary", "cornell2880_bounce2", "rtiow_bounce2"])
def test_kernels_are_the_plain_resort_on_frame_wavefronts(waves, name):
    wave = waves[name]
    if name != "cornell2880_primary":  # dead lanes mixed in
        assert 0 < int(wave[5].sum()) < wave[5].shape[0]
    _check_wave(wave)


@pytest.mark.parametrize("name", ["all_dead", "one_lane", "equal_origins", "equal_keys",
                                  "nan_origin"])
def test_kernels_are_the_plain_resort_on_edge_cases(card, name):
    _check_wave(_edge(name, card))


def test_a_traced_frame_sorts_every_lane_through_the_kernels(card):
    scene = load_scene("proc://cornell")
    b = get_backend("cuda", device=card)
    b.initialize(960, 960)
    b.set_scene(scene)
    b.samples_per_pixel = 2
    b.render(*_view(scene), True)  # the kernels load in the first frame
    before = sort_cuda.LAUNCHES
    tracing.enable(True)
    try:
        b.render(*_view(scene), False)
    finally:
        tracing.enable(False)
    counts = tracing.frame_summary()["counts"]
    assert sort_cuda.LAUNCHES - before == 3 * 5 * 2
    assert counts["lanes.sorted_kernel"] == 5 * 960 * 960 * 2


def test_two_shards_on_one_card_give_the_one_devices_image(card):
    scene = load_scene("proc://hall?subdiv=1&textured=1")
    out = []
    for devices in (0, [card] * 2):
        b = get_backend("cuda", devices=devices, rebalance=True)
        b.initialize(320, 180)
        b.set_scene(scene)
        before = sort_cuda.LAUNCHES
        frames = [b.render(*_view(scene), i == 0) for i in range(2)]
        out.append(([f.rays_traced for f in frames], b.img.copy(), sort_cuda.LAUNCHES - before))
    (rays, img, launches), (shard_rays, shard_img, shard_launches) = out
    assert rays == shard_rays
    assert np.array_equal(img, shard_img)
    assert (launches, shard_launches) == (3 * 5 * 2, 3 * 5 * 2 * 2)
