"""The port's brute-force oracle (ops/intersect.py brute_force_closest /
brute_force_any, engine/trace_bruteforce.py) and its `reference` backend
against the JAX package's.

- The brute force against the JAX functions on seeded rays and triangles:
  T not a multiple of the block, misses, a per-ray t_max. Tolerance as in
  tests/test_torch_traverse.py (XLA on the CPU fuses multiply-adds, the
  port does not): triangle ids equal except on t ties, at most
  max(2, R / 50000) lanes; t within rtol 1e-5, u/v within 2e-5.
- Tiling the rays changes no bit.
- The port's `reference` against the JAX `reference` (each package loading
  the scene with its own loader; the JAX frames render in their own
  process, tests/subproc_render.py), held to
  tests/test_cross_backend.py's _assert_images_match.
- The port's `cuda` (plain traversal on the CPU) against the port's
  `reference` on the JAX bench's image gate (bench.py:174-190: the
  textured hall at 128x72, one frame, 8-bit MAD < 1.0), and the brute
  force against the plain BVH walk on the gate scene's primary rays.
- A checkpoint of either package's `reference` resumes in the other's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.core import get_backend as jax_get_backend
from chameleonrt_tpu.ops import intersect as jint
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import trace_bruteforce, trace_bvh
from chameleonrt_tpu_torch.engine.backend_reference import ReferenceBackend
from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
from chameleonrt_tpu_torch.ops import camera, rng
from chameleonrt_tpu_torch.ops import intersect as tint
from chameleonrt_tpu_torch.ops.math import EPSILON
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match, render_frames

torch.set_num_threads(1)

T_RTOL = 1e-5
UV_ATOL = 2e-5
# the JAX bench's image gate (bench.py:174-190)
GATE_URI = "proc://hall?subdiv=1&textured=1&columns=4"
GATE_W, GATE_H = 128, 72


def _soup(n_tri, n_rays, seed):
    """Seeded triangles in a box, and rays from inside it in random
    directions: some hit, some miss."""
    r = np.random.default_rng(seed)
    centers = r.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    v0 = centers + r.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e1 = r.uniform(-1.0, 1.0, (n_tri, 3)).astype(np.float32)
    e2 = r.uniform(-1.0, 1.0, (n_tri, 3)).astype(np.float32)
    orig = r.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orig, d, v0, e1, e2


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _assert_closest_close(ref, got):
    t0, p0, u0, v0 = (np.asarray(x) for x in ref)
    t1, p1, u1, v1 = (x.numpy() for x in got)
    R = t0.shape[0]
    assert p1.dtype == np.int32
    mism = p0 != p1
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} triangle mismatches"
    # a mismatch is a tie: both nearest candidates at the same t, to rounding
    np.testing.assert_allclose(t1, t0, rtol=T_RTOL, atol=0)
    both = ~mism & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)


# (triangles, rays, seed, per-ray t_max): 1300 triangles fill two blocks of
# 512 and part of a third; with 20 triangles most rays miss
CLOSEST_CASES = {
    "partial_block": (1300, 1024, 3, False),
    "mostly_misses": (20, 512, 4, False),
    "per_ray_t_max": (1300, 1024, 5, True),
}


@pytest.mark.parametrize("case", sorted(CLOSEST_CASES))
def test_brute_force_closest_matches_jax(case):
    n_tri, n_rays, seed, per_ray = CLOSEST_CASES[case]
    o, d, v0, e1, e2 = _soup(n_tri, n_rays, seed)
    ref = jint.brute_force_closest(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)), t_min=1e-4)
    ref = tuple(np.asarray(x) for x in ref)
    if per_ray:
        # the JAX function takes a scalar t_max: a per-ray t_max keeps a
        # hit below it and turns the others into misses
        t_max = np.random.default_rng(seed).uniform(0.0, 20.0, n_rays).astype(np.float32)
        keep = ref[0] < t_max
        ref = (np.where(keep, ref[0], np.float32(1e20)), np.where(keep, ref[1], -1),
               np.where(keep, ref[2], 0.0), np.where(keep, ref[3], 0.0))
        got = tint.brute_force_closest(*_torch(o, d, v0, e1, e2), t_min=1e-4,
                                       t_max=torch.from_numpy(t_max))
        assert 0 < keep.sum() < (ref[1] >= 0).size
    else:
        got = tint.brute_force_closest(*_torch(o, d, v0, e1, e2), t_min=1e-4)
    _assert_closest_close(ref, got)
    hits = (got[1] >= 0).float().mean()
    assert 0 < hits < 1, hits
    miss = got[1] < 0
    assert (got[0][miss] == 1e20).all() and (got[2][miss] == 0).all()


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar_t_max", "per_ray_t_max"])
def test_brute_force_any_matches_jax(per_ray):
    o, d, v0, e1, e2 = _soup(1300, 1024, 6)
    t_max = (np.random.default_rng(6).uniform(0.0, 15.0, 1024).astype(np.float32) if per_ray
             else np.float32(15.0))
    ref = np.asarray(jint.brute_force_any(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)),
                                          t_min=EPSILON, t_max=jnp.asarray(t_max)))
    got = tint.brute_force_any(*_torch(o, d, v0, e1, e2), t_min=EPSILON,
                               t_max=torch.as_tensor(t_max)).numpy()
    assert (ref != got).sum() <= max(2, 1024 // 50000)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("max_pairs", [1, 512 * 7, 512 * 100])
def test_ray_tiling_is_bit_equal(max_pairs, monkeypatch):
    """Chunks of 1 ray, of 7 rays (1000 is not a multiple), and of 100."""
    o, d, v0, e1, e2 = _torch(*_soup(1300, 1000, 8))
    t_max = torch.from_numpy(np.random.default_rng(8).uniform(0.0, 20.0, 1000).astype(np.float32))

    def both(pairs):
        monkeypatch.setattr(tint, "MAX_PAIRS", pairs)
        return (tint.brute_force_closest(o, d, v0, e1, e2, 1e-4, t_max),
                tint.brute_force_any(o, d, v0, e1, e2, EPSILON, t_max))

    (whole, whole_any), (tiled, tiled_any) = both(1 << 30), both(max_pairs)
    assert len(tint._ray_chunks(1000)) == -(-1000 // max(1, max_pairs // tint.BLOCK))
    for a, b in zip(whole, tiled):
        assert torch.equal(a, b)
    assert torch.equal(whole_any, tiled_any)


def test_hit_none_and_merge():
    a = tint.Hit.none(3, "cpu")
    assert (a.t == 1e20).all() and (a.tri == -1).all() and (a.inst == -1).all()
    assert a.tri.dtype == torch.int32
    b = tint.Hit(t=torch.tensor([1.0, 1e20, 2.0]), tri=torch.tensor([4, -1, 5], dtype=torch.int32),
                 inst=torch.tensor([0, -1, 1], dtype=torch.int32), u=torch.full((3,), 0.25),
                 v=torch.full((3,), 0.5))
    m = a.merge(b)
    assert m.tri.tolist() == [4, -1, 5] and torch.equal(m.t, b.t)
    # a tie keeps the first
    c = b._replace(tri=torch.tensor([7, 7, 7], dtype=torch.int32))
    assert b.merge(c).tri.tolist() == [4, -1, 5]


def _camera(scene):
    """tests/subproc_render.py's view."""
    cam = scene.cameras[0]
    d = cam.center - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


def _render(backend, uri, W, H, n_frames):
    scene = load_scene(uri)
    backend.initialize(W, H)
    backend.set_scene(scene)
    view = _camera(scene)
    for i in range(n_frames):
        stats = backend.render(*view, i == 0, readback_framebuffer=(i == n_frames - 1))
    return backend, stats


@pytest.mark.parametrize("uri, n_frames", [("proc://cornell", 3),
                                           ("proc://instances?nx=2&ny=2&subdiv=1", 2)])
def test_reference_matches_jax_reference(uri, n_frames, tmp_path):
    img_ref, acc_ref, _ = render_frames("reference", uri, 40, n_frames, tmpdir=str(tmp_path))
    b, stats = _render(ReferenceBackend(device="cpu"), uri, 40, 40, n_frames)
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    assert stats.rays_traced > 40 * 40
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)


@pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")
def test_cuda_matches_reference_on_the_bench_image_gate():
    imgs = {}
    for name, backend in (("reference", ReferenceBackend(device="cpu")),
                          ("cuda", get_backend("cuda", device="cpu"))):
        b, _ = _render(backend, GATE_URI, GATE_W, GATE_H, 1)
        imgs[name] = b.img[..., :3].astype(np.float32)
    assert imgs["reference"].max() > 0
    mad = float(np.abs(imgs["cuda"] - imgs["reference"]).mean())
    assert mad < 1.0, mad


@pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")
def test_brute_force_matches_the_bvh_walk_on_the_gate_wavefront():
    """Primary rays of the gate scene through both scene traversals (the
    plain walk over the BVH4 table, and the brute force), and occlusion up
    to 1.001 and 0.999 of each hit. Both run the same Möller–Trumbore on
    the same floats, so a triangle both find has the same t, u and v."""
    scene = load_scene(GATE_URI)
    flat, meta = build_device_scene(scene, torch.device("cpu"))
    flat = flat._replace(blas=trace_bvh.build_blas_set(flat, meta))
    W, H = GATE_W, GATE_H
    view = camera.compute_view_params(*_camera(scene), W, H)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    _, orig, dirs = camera.generate_primary_rays(view, px, py, float(W), float(H),
                                                 rng.get_rng(px + py * W, 1))
    R = orig.shape[0]
    active = torch.ones(R, dtype=torch.bool)
    active[::9] = False
    bvh_closest, bvh_any = trace_bvh.make_trace_fns(meta, use_kernels=False)
    bf_closest, bf_any = trace_bruteforce.make_trace_fns(meta)
    want, got = bvh_closest(flat, orig, dirs, 0.0, active), bf_closest(flat, orig, dirs, 0.0, active)
    mism = got.tri != want.tri
    assert int(mism.sum()) <= max(2, R // 50000)
    assert torch.equal(got.t, want.t)
    same = ~mism & want.hit
    assert int(same.sum()) > R // 2
    assert torch.equal(got.u[same], want.u[same]) and torch.equal(got.v[same], want.v[same])
    assert (got.tri[~active] == -1).all() and (got.inst[~active] == -1).all()
    for factor in (1.001, 0.999):
        t_max = torch.where(want.t < 1e19, want.t * factor, torch.full_like(want.t, 100.0))
        occ_bvh, occ_bf = bvh_any(flat, orig, dirs, t_max, active), bf_any(flat, orig, dirs, t_max, active)
        assert int((occ_bvh != occ_bf).sum()) <= max(2, R // 50000)
        assert not occ_bf[~active].any()


@pytest.fixture(scope="module")
def jax_reference():
    scene = jax_load_scene("proc://cornell")
    b = jax_get_backend("reference")
    b.initialize(16, 16)
    b.set_scene(scene)
    return b, _camera(scene)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(direction, jax_reference, tmp_path):
    """Two frames in one package, saved; the other loads the state and
    renders the third frame, which must match the first package's third."""
    jb, view = jax_reference
    pb = ReferenceBackend(device="cpu")
    pb.initialize(16, 16)
    pb.set_scene(load_scene("proc://cornell"))
    src, dst = (jb, pb) if direction == "jax_to_port" else (pb, jb)
    for i in range(2):
        src.render(*view, i == 0, readback_framebuffer=False)
    path = str(tmp_path / "state.npz")
    src.save_state(path)
    dst.load_state(path)
    assert dst.frame_id == 2
    src.render(*view, False)
    dst.render(*view, False)
    _assert_images_match(src.img[..., :3].astype(np.float32), dst.img[..., :3].astype(np.float32),
                         np.asarray(src._accum), np.asarray(dst._accum))


def test_reference_is_registered_and_needs_a_card():
    b = get_backend("reference")
    assert isinstance(b, ReferenceBackend) and b.device.type == "cuda"
    assert b.name == "Reference (brute-force torch)"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        b.initialize(8, 8)
