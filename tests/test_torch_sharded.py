"""The port's multi-device rendering (chameleonrt_tpu_torch/parallel/)
against tests/test_sharded.py's cases, on CPU shards.

A mesh of the port may name one device several times, so N shards run on
the CPU here as on one card. Each case holds the port's sharded frames to
its single-device frames (sRGB8 images and rays exactly, accumulators
within rtol 1e-5: the CPU's vector and scalar loops may round a
transcendental a unit apart, and a shard moves lanes between them), and to the
JAX package's sharded path on the virtual 8-device CPU mesh under
tests/test_cross_backend.py's _assert_images_match. The exchange of
wavefront rows is held bit for bit to the JAX package's, run under
shard_map on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chameleonrt_tpu.core import get_backend as jax_get_backend
from chameleonrt_tpu.engine import device_scene as jds
from chameleonrt_tpu.engine import path_tracer as jpt
from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.ops import camera as jcam
from chameleonrt_tpu.parallel import sharded as jsharded
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core import get_backend
from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.ops import camera as camera_ops
from chameleonrt_tpu_torch.ops.tonemap import linear_to_srgb_u8
from chameleonrt_tpu_torch.parallel import sharded
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

CPU = torch.device("cpu")
CORNELL = "proc://cornell"
# C2: the packages may part by one bounce of one path a sample (3 rays)
RAYS_ALLOWANCE = 3


def _view(scene, tilt=0.0):
    """The scene's first camera; tilt raises the look-at point (the
    framing of test_sharded.py's rebalance case, where the box fills the
    lower rows only)."""
    cam = scene.cameras[0]
    d = (cam.center + np.float32([0.0, tilt, 0.0])) - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


def _port(n, W, H, rebalance=False):
    """The port's CPU `cuda` backend on proc://cornell over n CPU shards."""
    b = get_backend("cuda", device="cpu", devices=[CPU] * n, rebalance=rebalance)
    b.initialize(W, H)
    b.set_scene(load_scene(CORNELL))
    return b


def _frames(b, n_frames, tilt=0.0):
    """n_frames progressive frames: (sRGB8 image, accumulator, rays per frame)."""
    pos, d, up, fov = _view(load_scene(CORNELL), tilt)
    rays = [b.render(pos, d, up, fov, i == 0).rays_traced for i in range(n_frames)]
    return b.img.copy(), b.framebuffer().numpy().copy(), rays


def test_sharded_progressive_frames_match_single_device():
    """test_sharded.py's progressive case: 4 shards of proc://cornell at
    16x32, 3 frames through make_sharded_render_step, equal after every
    frame to the port's single-device frames (rtol 1e-5, rays exactly) and, under
    _assert_images_match, to the JAX package's sharded step on the virtual
    mesh."""
    n_dev, W, H = 4, 16, 32
    b = _port(1, W, H)
    trace = b._trace
    mesh = sharded.make_mesh([CPU] * n_dev)
    step = sharded.make_sharded_render_step(b.meta, {CPU: trace}, mesh, W, H, 1)
    flats = sharded.replicate_scene(b.flat, mesh)
    assert flats[CPU] is b.flat
    accum = sharded.shard_accum(torch.zeros((H, W, 3)), mesh)
    single = torch.zeros((H, W, 3))

    scene = jax_load_scene(CORNELL)
    jflat, jmeta = jds.build_device_scene(scene)
    jflat = jflat._replace(blas=jtb.build_blas_set(jflat, jmeta))
    tc, ta = jtb.make_trace_fns(jmeta)
    jmesh = jsharded.make_mesh(jax.devices()[:n_dev])
    jstep = jsharded.make_sharded_render_step(jmeta, tc, ta, jmesh, W, H, 1)
    jflat = jsharded.replicate_scene(jflat, jmesh)
    jaccum = jsharded.shard_accum(jnp.zeros((H, W, 3), jnp.float32), jmesh)

    pos, d, up, fov = _view(scene)
    view = camera_ops.compute_view_params(pos, d, up, fov, W, H)
    jview = jcam.compute_view_params(pos, d, up, fov, W, H)
    px, py = b._pixels
    for fid in range(3):
        illum, rays_s = path_tracer.render_pixels(b.flat, b.meta, *trace, view, fid, px, py,
                                                  W, H, 1)
        single = path_tracer.progressive_accum(single, illum.reshape(H, W, 3), fid)
        accum, rays_m = step(flats, view, accum, fid)
        assert [tuple(a.shape) for a in accum] == [(H // n_dev, W, 3)] * n_dev
        torch.testing.assert_close(torch.cat(accum), single, rtol=1e-5, atol=1e-6)
        assert int(rays_m) == int(rays_s)
        jaccum, jrays = jstep(jflat, jview, jaccum, jnp.uint32(fid))
        assert abs(int(jrays) - int(rays_m)) <= RAYS_ALLOWANCE
    assert step.lanes_moved == 0  # no exchange without rebalance
    jaccum = torch.from_numpy(np.array(jaccum))
    _assert_images_match(_srgb(jaccum), _srgb(single), jaccum.numpy(), single.numpy())


def _srgb(accum):
    return linear_to_srgb_u8(accum)[..., :3].numpy().astype(np.float32)


@pytest.mark.parametrize("rebalance", [False, True], ids=["static", "rebalanced"])
def test_backend_devices_image_equal_with_padding(rebalance):
    """The backend's devices= with H % n != 0 (test_sharded.py's case: 8
    shards at 32x35, the last one all padding): the sRGB8 image and (rtol
    1e-5) the accumulator of the single-device backend, rays exactly equal (the
    padding rows trace nothing), and the JAX backend's image over the
    virtual 8-device mesh under _assert_images_match."""
    n_dev, W, H = 8, 32, 35
    one = _frames(_port(1, W, H), 2)
    b = _port(n_dev, W, H, rebalance)
    img, acc, rays = _frames(b, 2)
    assert b._accum_height() == 40 and len(b._accum) == n_dev
    assert img.shape == (H, W, 4)
    np.testing.assert_array_equal(img, one[0])
    np.testing.assert_allclose(acc, one[1], rtol=1e-5, atol=1e-6)
    assert rays == one[2]
    if rebalance:
        return
    jb = jax_get_backend("tpu", devices=n_dev)
    jb.initialize(W, H)
    jb.set_scene(jax_load_scene(CORNELL))
    pos, d, up, fov = _view(load_scene(CORNELL))
    jrays = [jb.render(pos, d, up, fov, i == 0).rays_traced for i in range(2)]
    for got, want in zip(rays, jrays):
        assert abs(got - want) <= RAYS_ALLOWANCE
    _assert_images_match(jb.img[..., :3].astype(np.float32), img[..., :3].astype(np.float32),
                         np.asarray(jb._accum)[:H], acc)


def test_rebalance_image_equal_and_migrates():
    """test_sharded.py's rebalance case (tilted cornell framing, 8 shards at
    24x64, the box in the lower rows): the rebalanced frame equals the
    static one and the single-device one (sRGB8 exactly, accumulators
    within rtol 1e-5), with equal rays, and the
    exchanges moved active lanes."""
    n_dev, W, H = 8, 24, 64
    frames = {}
    for n, reb in ((1, False), (n_dev, False), (n_dev, True)):
        b = _port(n, W, H, reb)
        frames[n, reb] = (*_frames(b, 1, tilt=1.2), b._step.lanes_moved if b._step else 0)
    single = frames[1, False]
    for key in ((n_dev, False), (n_dev, True)):
        img, acc, rays, _ = frames[key]
        np.testing.assert_array_equal(img, single[0])
        np.testing.assert_allclose(acc, single[1], rtol=1e-5, atol=1e-6)
        assert rays == single[2]
    assert frames[n_dev, False][3] == 0 and frames[n_dev, True][3] > 0


def test_single_shard_entry_points():
    """trace_path and render_pixels, the one-wavefront counterparts of the
    JAX package's: trace_path's illumination, scattered by its lane ids,
    is render_pixels' frame with the same rays; render_pixels with
    scatter_ids places each lane's result at its id of a scatter_rows
    frame, and the lanes that active0 starts dead trace and count
    nothing."""
    from chameleonrt_tpu_torch.ops import rng as rng_ops

    W, H = 16, 16
    b = _port(1, W, H)
    view = camera_ops.compute_view_params(*_view(load_scene(CORNELL)), W, H)
    px, py = b._pixels
    full, rays = path_tracer.render_pixels(b.flat, b.meta, *b._trace, view, 0, px, py, W, H, 1)

    state = rng_ops.get_rng(px + py * W, 1)
    state, orig, dirs = camera_ops.generate_primary_rays(view, px, py, float(W), float(H), state)
    _, illum, lane_pixel, rays_p = path_tracer.trace_path(b.flat, b.meta, *b._trace, orig, dirs,
                                                          state)
    assert torch.equal(torch.zeros_like(full).index_put((lane_pixel,), illum), full)
    assert int(rays_p) == int(rays)

    rows = (py >= 4) & (py < 12)
    live = (py >= 4) & (py < 10)
    frame, rays_s = path_tracer.render_pixels(
        b.flat, b.meta, *b._trace, view, 0, px[rows], py[rows], W, H, 1,
        scatter_ids=(py * W + px)[rows], scatter_rows=H * W, active0=live[rows],
    )
    assert frame.shape == (H * W, 3)
    assert not frame[~live].any()
    torch.testing.assert_close(frame[live], full[live], rtol=1e-5, atol=1e-6)
    _, rays_live = path_tracer.render_pixels(b.flat, b.meta, *b._trace, view, 0, px[live],
                                             py[live], W, H, 1)
    assert int(rays_s) == int(rays_live)


def _jax_exchange(n_dev, bit, fields):
    """The JAX package's _exchange_wavefront under shard_map over the first
    n_dev virtual devices."""
    mesh = jsharded.make_mesh(jax.devices()[:n_dev])

    def body(*f):
        return jpt._exchange_wavefront(*f, axis=jsharded.AXIS, bit=bit, n_dev=n_dev)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(jsharded.AXIS),) * 7,
                              out_specs=(P(jsharded.AXIS),) * 7, check_vma=False))
    return [np.asarray(x) for x in f(*fields)]


EXCHANGES = [(n, 1 << b) for n in (2, 3, 4, 8) for b in range(max(1, (n - 1).bit_length()))]


@pytest.mark.parametrize("n_dev, bit", EXCHANGES, ids=[f"n{n}_bit{b}" for n, b in EXCHANGES])
def test_exchange_wavefront_bit_equal_to_jax(n_dev, bit):
    """One exchange along `bit` on n_dev sorted wavefronts of 96 lanes
    (actives first, a random active count each; shard 0 full, its partner
    idle): every
    field bit-equal to the JAX package's, lane ids and the active count
    conserved, and the lanes moved those that changed shard."""
    R = 96
    rng = np.random.default_rng(7 * n_dev + bit)
    n_act = rng.integers(0, R + 1, n_dev)
    n_act[0], n_act[bit] = R, 0  # one pair certainly moves lanes
    active = np.arange(R)[None, :] < n_act[:, None]
    state = rng.integers(0, 2**32, (n_dev, R), dtype=np.uint64).astype(np.uint32)
    ids = rng.permutation(n_dev * R).astype(np.int32).reshape(n_dev, R)
    f3 = [rng.normal(size=(n_dev, R, 3)).astype(np.float32) for _ in range(4)]
    jax_fields = [jnp.asarray(x.reshape((n_dev * R,) + x.shape[2:]))
                  for x in (state, *f3, active, ids)]
    want = _jax_exchange(n_dev, bit, jax_fields)

    waves = [(torch.from_numpy(state[d].astype(np.int64)),
              *[torch.from_numpy(x[d]) for x in f3],
              torch.from_numpy(active[d]), torch.from_numpy(ids[d].astype(np.int64)))
             for d in range(n_dev)]
    out, moved = path_tracer._exchange_wavefront(waves, bit)
    got = [np.concatenate([w[k].numpy() for w in out]) for k in range(7)]
    np.testing.assert_array_equal(got[0].astype(np.uint32), want[0])
    for k in range(1, 5):  # bit for bit
        np.testing.assert_array_equal(got[k].view(np.int32), want[k].view(np.int32))
    np.testing.assert_array_equal(got[5], want[5])
    np.testing.assert_array_equal(got[6], want[6])
    assert sorted(got[6].tolist()) == list(range(n_dev * R))
    assert got[5].sum() == active.sum()
    home = {int(i): d for d in range(n_dev) for i in ids[d][active[d]]}
    now = got[6].reshape(n_dev, R)
    assert moved == sum(int(home[int(i)] != d) for d in range(n_dev)
                        for i in now[d][got[5].reshape(n_dev, R)[d]])
    assert moved > 0


def test_checkpoints_across_shard_counts(tmp_path):
    """save_state crops the padding and load_state pads and splits: a
    checkpoint of 3 shards at 24x20 (20 % 3 != 0) resumes on one device and
    in the JAX backend, and one of a single device and of the JAX backend
    resumes on 3 shards; the accumulators load equal and the resumed
    frames agree (the port's sRGB8 exactly and within rtol 1e-5, the JAX
    backend's under _assert_images_match)."""
    W, H = 24, 20
    pos, d, up, fov = _view(load_scene(CORNELL))
    three, one = _port(3, W, H), _port(1, W, H)
    _frames(three, 2)
    path = str(tmp_path / "three.npz")
    three.save_state(path)
    with np.load(path) as z:
        assert z["accum"].shape == (H, W, 3) and int(z["frame_id"]) == 2
    one.load_state(path)
    jb = jax_get_backend("tpu")
    jb.initialize(W, H)
    jb.set_scene(jax_load_scene(CORNELL))
    jb.load_state(path)
    np.testing.assert_array_equal(one.framebuffer().numpy(), three.framebuffer().numpy())
    np.testing.assert_array_equal(np.asarray(jb._accum), three.framebuffer().numpy())
    np.testing.assert_array_equal(one.img, three.img)
    for b in (three, one, jb):
        b.render(pos, d, up, fov, False)
    assert three.frame_id == one.frame_id == jb.frame_id == 3
    np.testing.assert_array_equal(one.img, three.img)
    torch.testing.assert_close(one.framebuffer(), three.framebuffer(), rtol=1e-5, atol=1e-6)
    _assert_images_match(jb.img[..., :3].astype(np.float32), one.img[..., :3].astype(np.float32),
                         np.asarray(jb._accum), one.framebuffer().numpy())

    # the other way round: one device's and the JAX backend's checkpoints on 3 shards
    for src, name in ((one, "one.npz"), (jb, "jax.npz")):
        path = str(tmp_path / name)
        src.save_state(path)
        dst = _port(3, W, H)
        dst.load_state(path)
        assert dst.frame_id == 3 and [tuple(a.shape) for a in dst._accum] == [(7, W, 3)] * 3
        np.testing.assert_array_equal(dst.framebuffer().numpy(), np.asarray(
            src.framebuffer() if src is one else src._accum))
        if src is one:
            for b in (src, dst):
                b.render(pos, d, up, fov, False)
            np.testing.assert_array_equal(dst.img, src.img)
            torch.testing.assert_close(dst.framebuffer(), src.framebuffer(), rtol=1e-5, atol=1e-6)
