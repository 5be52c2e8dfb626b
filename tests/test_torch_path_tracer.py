"""The port's path tracer against chameleonrt_tpu's.

- One shading stage (_shade_bounce) on the same lanes, tables and hits.
- Whole frames: the port's `cuda` backend on the port's own loader's
  scene, on the CPU (plain traversal), against the JAX `tpu` backend
  rendered in its own process by
  tests/subproc_render.py, held to tests/test_cross_backend.py's
  _assert_images_match.
- save_state / load_state round trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.engine import device_scene as jds
from chameleonrt_tpu.engine import path_tracer as jpt
from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.ops import camera as jcam
from chameleonrt_tpu.ops import rng as jrng
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import convert, native
from chameleonrt_tpu_torch.core import get_backend
from chameleonrt_tpu_torch.engine import path_tracer as tpt
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match, render_frames

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

HALL = "proc://hall?subdiv=1&textured=1&columns=4"
# nine rotated instances of one box mesh under two materials: the
# two-level tables, traced by the plain versions of B3 and B4
INSTANCES = "proc://instances?nx=3&ny=3&subdiv=1"


def _camera(scene):
    """tests/subproc_render.py's view."""
    if scene.cameras:
        cam = scene.cameras[0]
        pos, center, up, fov = cam.position, cam.center, cam.up, cam.fov_y
    else:
        pos = np.array([0.0, 1.0, 5.0], np.float32)
        center = np.zeros(3, np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        fov = 65.0
    d = center - pos
    return pos, d / np.linalg.norm(d), up, fov


def _render_port(uri, res, n_frames, **backend_kwargs):
    scene = load_scene(uri)
    b = get_backend("cuda", device="cpu", **backend_kwargs)
    b.initialize(res, res)
    b.set_scene(scene)
    pos, d, up, fov = _camera(scene)
    for i in range(n_frames):
        b.render(pos, d, up, fov, i == 0, readback_framebuffer=(i == n_frames - 1))
    return b


@pytest.mark.parametrize(
    "uri, res, n_frames", [("proc://cornell", 40, 3), (HALL, 64, 1), (INSTANCES, 40, 2)]
)
def test_frames_match_jax_tpu_backend(uri, res, n_frames, tmp_path):
    img_ref, acc_ref, _ = render_frames("tpu", uri, res, n_frames, tmpdir=str(tmp_path))
    b = _render_port(uri, res, n_frames)
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)


def _shade_both(uri):
    """One shading stage at bounce 3 (roulette on) through both packages:
    the same tables (convert.from_jax), rays, RNG states and hits. Returns
    (port ShadeOut, JAX ShadeOut, active lanes, JAX hit)."""
    scene = jax_load_scene(uri)
    jflat, jmeta, host = jds.build_device_scene(scene, want_host=True)
    jflat = jflat._replace(blas=jtb.build_blas_set(jflat, jmeta, host))
    flat, meta = convert.from_jax(
        jax.tree.map(np.asarray, jflat), jmeta, jax.tree.map(np.asarray, jflat.blas),
        torch.device("cpu"),
    )
    W = H = 32
    pos, d, up, fov = _camera(scene)
    view = jcam.compute_view_params(pos, d, up, fov, W, H)
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    state = jrng.get_rng(px + py * W, jnp.uint32(5))
    state, orig, dirs = jcam.generate_primary_rays(view, px, py, float(W), float(H), state)
    R = orig.shape[0]
    active = jnp.ones((R,), bool).at[::7].set(False)
    closest, _ = jtb.make_trace_fns(jmeta)
    hit = closest(jflat, orig, dirs, 0.0, active)
    active = active & hit.hit
    hit_p = orig + hit.t[:, None] * dirs
    tp = jnp.asarray(np.random.default_rng(2).uniform(0.2, 1.0, (R, 3)).astype(np.float32))
    bounce = 3
    want = jpt._shade_bounce(jflat, jmeta, bounce, state, orig, dirs, tp, active, hit_p,
                             hit.tri, hit.inst, hit.u, hit.v)

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x.copy())

    got = tpt._shade_bounce(flat, meta, bounce, t(state), t(orig), t(dirs), t(tp), t(active),
                            t(hit_p), t(hit.tri), t(hit.inst), t(hit.u), t(hit.v))
    return got, want, np.asarray(active), hit


def _assert_shade_close(got, want, live, light_lanes=None):
    """light_lanes: the lanes on which t_light is compared (default: the
    live ones)."""
    np.testing.assert_array_equal(got.state.numpy().astype(np.uint32), np.asarray(want.state))
    for name in ("shoot1", "shoot2", "new_active"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert (a != b).sum() <= 2, name
    # lanes that missed hold unobservable values (hit points at t = 1e20):
    # compare the live ones
    same = live & (got.new_active.numpy() == np.asarray(want.new_active))
    for name, lanes in (("light_dir", live), ("light_dist", live), ("w_i2", live),
                        ("t_light", live if light_lanes is None else light_lanes),
                        ("cont_dir", live)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[lanes], b[lanes], atol=1e-5, rtol=1e-5, err_msg=name)
    # contributions carry f / pdf at sampled lobe peaks: see test_torch_bsdf
    for name in ("c1", "c2", "new_throughput"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[same], b[same], atol=1e-5, rtol=1e-3, err_msg=name)


def test_shade_bounce_matches_jax():
    """One shading stage on the textured hall (one instance: the material
    rides in the shade row)."""
    got, want, live, _ = _shade_both(HALL)
    assert live.sum() > live.shape[0] // 2
    _assert_shade_close(got, want, live)


def test_shade_bounce_multi_instance_matches_jax():
    """One shading stage on the bench's instanced parity scene (16 rotated
    instances, two materials): each lane's material comes from its
    instance's material table and its normal from its instance's matrix.
    The shade rows of a multi-instance scene carry no material, so reading
    them instead gives all-zero materials, and instance 0's matrix gives
    the other instances wrong normals; both change every output below.

    t_light, the distance to the light's plane along the bsdf sample, is
    compared where that sample shoots its shadow ray, the only lanes that
    use it: on a direction almost parallel to the plane it is
    ill-conditioned (measured: 1.02e-5 relative at t = 1368 on one of 152
    live lanes, a direction that misses the light)."""
    got, want, live, hit = _shade_both("proc://instances?nx=4&ny=4&subdiv=2")
    inst = np.asarray(hit.inst)[live]
    assert live.sum() > 100 and len(np.unique(inst)) >= 8
    shoot2 = live & got.shoot2.numpy() & np.asarray(want.shoot2)
    assert shoot2.any()
    _assert_shade_close(got, want, live, light_lanes=shoot2)
    # the throughput carries the lanes' own base colours (both materials)
    tp = got.new_throughput.numpy()[live & got.new_active.numpy()]
    assert (tp[:, 0] > tp[:, 2]).any() and (tp[:, 2] > tp[:, 0]).any()


def test_save_load_state_round_trip(tmp_path):
    b = _render_port("proc://cornell", 24, 2)
    path = str(tmp_path / "state.npz")
    b.save_state(path)
    c = get_backend("cuda", device="cpu")
    c.initialize(24, 24)
    c.set_scene(load_scene("proc://cornell"))
    c.load_state(path)
    assert c.frame_id == b.frame_id == 2
    assert torch.equal(c._accum, b._accum)
    np.testing.assert_array_equal(c.img, b.img)
    # resuming renders the same next frame as continuing
    pos, d, up, fov = _camera(load_scene("proc://cornell"))
    b.render(pos, d, up, fov, False)
    c.render(pos, d, up, fov, False)
    assert torch.equal(c._accum, b._accum)
    wrong = get_backend("cuda", device="cpu")
    wrong.initialize(16, 24)
    with pytest.raises(ValueError):
        wrong.load_state(path)
