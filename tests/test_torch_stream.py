"""The port's streamed tier (kernels B5a/B5b, ops/traverse_cuda.py) against
the JAX package.

- The gate (trace_bvh.streamed_tier) and the routing of make_trace_fns for
  traversal "auto", "stream" and "lane", with the L2's size set.
- The streamed route on a small city: the port on the CPU (the wrappers
  run the plain version there) against the JAX stream=True slot-lane
  kernels in interpret mode (the suite's S=16, 8-slot shapes), on a
  sorted camera wavefront and a diffuse-bounce wavefront.
- The whole slice: the `cuda` backend on the CPU with traversal "stream" against
  the JAX `tpu` backend, held to tests/test_cross_backend.py's
  _assert_images_match.

Tolerances are those of test_torch_traverse.py (XLA on the CPU fuses
multiply-adds, the port does not): t within rtol 1e-5, u/v within 2e-5,
prims equal except on at most max(2, R / 50000) lanes (exact-t ties);
occlusion flags equal.

The JAX stream=True kernels DMA one row per packet slot of 32 sorted rays;
on the card B5a and B5b walk one ray a lane in the plain walk's order,
bit-equal to it (chip_smoke.py holds them so there,
tests/test_torch_walk_host.py holds their walks on the host), so their
plain version is the wrappers' CPU route here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.ops import camera as jcam
from chameleonrt_tpu.ops import rng as jrng
from chameleonrt_tpu.ops import traverse_slotlane as tsl
from chameleonrt_tpu.ops.lbvh import PackedBvh as JaxPackedBvh
from chameleonrt_tpu.ops.traverse import ray_sort_perm_only as jax_sort_perm
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match, render_frames
from test_torch_path_tracer import _camera, _render_port
from test_torch_route import l2_of, spy_launches

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

T_RTOL = 1e-5
UV_ATOL = 2e-5
CITY = "proc://city?n=8"
INSTANCES = "proc://instances?nx=2&ny=2&subdiv=0"
W, H = 64, 36
SOUP_STACK = 48  # stack4 of proc://random?n_tris=6700000&spread=12 (native build)


@pytest.fixture(scope="module")
def city():
    """(scene, FlatScene with its tables, SceneMeta) of the small city."""
    scene = load_scene(CITY)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


@pytest.fixture(scope="module")
def unified_table():
    scene = load_scene(INSTANCES)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return ttb.build_blas_set(flat, meta)[0].any


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _rays(table_nodes, R, seed):
    """R rays from inside the table's root box in random directions."""
    rng = np.random.default_rng(seed)
    row = table_nodes[0].numpy()
    lo = np.min([row[6 * c : 6 * c + 3] for c in range(4) if row[6 * c] < 1e29], axis=0)
    hi = np.max([row[6 * c + 3 : 6 * c + 6] for c in range(4) if row[6 * c] < 1e29], axis=0)
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def test_gate_compares_the_table_with_the_l2(city):
    _, flat, _ = city
    table = flat.blas[0].any
    n = ttb.table_bytes(table)
    assert n == (table.nodes.shape[0] * 32 + table.leaf_rows.shape[0] * 40) * 4
    assert ttb.streamed_tier(table, l2_bytes=n - 1)
    assert not ttb.streamed_tier(table, l2_bytes=n)
    assert not ttb.streamed_tier(table)  # a table on the CPU has no L2


@pytest.mark.parametrize(
    "traversal, l2_fits, want",
    [
        ("auto", False, "stream"),
        ("auto", True, "flat"),
        ("stream", True, "stream"),
        ("lane", False, "flat"),
    ],
)
def test_make_trace_fns_routes_by_tier(city, traversal, l2_fits, want, monkeypatch):
    """The kernels the returned trace functions launch, for each traversal,
    with the L2 budget just above or just below the table."""
    _, flat, meta = city
    monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    calls = spy_launches(monkeypatch)
    n = ttb.table_bytes(flat.blas[0].any)
    l2_of(monkeypatch, n if l2_fits else n - 1)
    closest, any_ = ttb.make_trace_fns(meta, traversal, blas=flat.blas)
    o, d = _rays(flat.blas[0].any.nodes, 32, seed=3)
    active = torch.ones((32,), dtype=torch.bool)
    hit = closest(flat, o, d, 1e-4, active)
    any_(flat, o, d, torch.where(hit.tri >= 0, hit.t, torch.full_like(hit.t, 30.0)), active)
    suffix = "_stream" if want == "stream" else ""
    assert calls == ["closest" + suffix, "any" + suffix]


def test_make_trace_fns_tier_arguments(city, monkeypatch):
    """The plain traversal launches nothing and needs no tables; the gate
    of "auto" needs the tables, of a flat or a two-level scene; a named
    tier does not."""
    _, flat, meta = city
    monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    with monkeypatch.context() as m:
        m.setattr(traverse_cuda, "launch_closest", None)
        m.setattr(traverse_cuda, "launch_any", None)
        closest, any_ = ttb.make_trace_fns(meta, "plain")
        o, d = _rays(flat.blas[0].any.nodes, 16, seed=4)
        assert closest(flat, o, d, 1e-4, torch.ones((16,), dtype=torch.bool)).t.shape == (16,)
    with pytest.raises(ValueError, match="tables"):
        ttb.make_trace_fns(meta)
    imeta = tds.build_device_scene(load_scene(INSTANCES), torch.device("cpu"))[1]
    with pytest.raises(ValueError, match="tables"):
        ttb.make_trace_fns(imeta)
    assert len(ttb.make_trace_fns(imeta, "plain")) == 2
    for traversal in ("stream", "lane"):
        assert len(ttb.make_trace_fns(imeta, traversal)) == 2


@pytest.fixture(scope="module")
def city_wavefronts(city):
    """The JAX table built from the port's arrays, and two sorted
    wavefronts in the city's object space (its one instance is the
    identity): the camera's primary rays at 64x36 and diffuse bounces from
    their hits (uniform in the hemisphere of the face normal that faces
    the incoming ray, numpy seed 21; lanes that missed are inactive)."""
    scene, flat, _ = city
    table = flat.blas[0].any
    jtable = JaxPackedBvh(jnp.asarray(table.nodes.numpy()), jnp.asarray(table.leaf_rows.numpy()),
                          max_depth=table.max_depth)
    pos, d, up, fov = _camera(scene)
    view = jcam.compute_view_params(pos, d, up, fov, W, H)
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    state = jrng.get_rng(px + py * W, jnp.uint32(1))
    _, orig, dirs = jcam.generate_primary_rays(view, px, py, float(W), float(H), state)
    R = orig.shape[0]
    active = jnp.ones((R,), bool)
    perm = np.asarray(jax_sort_perm(orig, dirs, active))
    primary = tuple(np.asarray(x)[perm] for x in (orig, dirs, active))

    o, dd, a = primary
    t, prim, _, _ = plain.traverse_closest(table, *_torch(o, dd, np.zeros(R, np.float32), a),
                                           torch.full((R,), 1e20))
    hit = prim.numpy() >= 0
    p = o + np.where(hit, t.numpy(), 0.0)[:, None].astype(np.float32) * dd
    _, e1, e2 = tds.host_triangles(flat)
    n = np.cross(e1[np.maximum(prim.numpy(), 0)], e2[np.maximum(prim.numpy(), 0)])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where((np.sum(n * dd, axis=1) > 0)[:, None], -n, n)
    w = np.random.default_rng(21).normal(size=(R, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w = np.where((np.sum(w * n, axis=1) < 0)[:, None], -w, w)
    p, w = p.astype(np.float32), w.astype(np.float32)
    perm = np.asarray(jax_sort_perm(jnp.asarray(p), jnp.asarray(w), jnp.asarray(hit)))
    bounce = (p[perm], w[perm], hit[perm])
    return table, jtable, {"primary": (primary, 0.0), "bounce": (bounce, 1e-4)}


@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_stream_route_matches_jax_stream_kernels(city_wavefronts, wave):
    """B5a's and B5b's wrappers (the plain version on the CPU) against
    traverse_closest_slotlane / traverse_any_slotlane with stream=True in
    interpret mode, closest hit and then any hit at t_max factors 1.001
    and 0.999 of the closest hit (30 on a miss)."""
    table, jtable, waves = city_wavefronts
    (o, d, a), t_min = waves[wave]
    R = o.shape[0]
    tmin = np.full((R,), t_min, np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    ref = tsl.traverse_closest_slotlane(
        jtable, *(jnp.asarray(x) for x in (o, d, tmin, a)), t_max=jnp.asarray(tmax),
        interpret=True, S=16, k_slots=8, stream=True,
    )
    got = traverse_cuda.traverse_closest_stream(table, *_torch(o, d, tmin, a, tmax))
    t0, p0, u0, v0 = (np.asarray(x) for x in ref)
    t1, p1, u1, v1 = (x.numpy() for x in got)
    mism = p0 != p1
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} prim mismatches"
    same = ~mism
    np.testing.assert_allclose(t1[same], t0[same], rtol=T_RTOL, atol=0)
    both = same & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)
    assert both.sum() > a.sum() // 4
    assert (p1[~a] == -1).all()
    for factor in (1.001, 0.999):
        tm = np.where(t1 < 1e19, t1 * factor, 30.0).astype(np.float32)
        ref = np.asarray(tsl.traverse_any_slotlane(
            jtable, *(jnp.asarray(x) for x in (o, d, tmin, tm, a)),
            interpret=True, S=16, k_slots=8, stream=True,
        ))
        occ = traverse_cuda.traverse_any_stream(table, *_torch(o, d, tmin, tm, a)).numpy()
        np.testing.assert_array_equal(occ, ref)
        assert not occ[~a].any()
        if factor > 1:
            assert occ.sum() > a.sum() // 4


def test_stream_backend_frames_match_jax_tpu_backend(tmp_path, monkeypatch):
    """The whole slice on the small city: the cuda backend on the CPU with
    traversal "stream" (each bounce traces through B5a/B5b's launches)
    against the JAX tpu backend, 40 px x 2 frames."""
    calls = spy_launches(monkeypatch)
    img_ref, acc_ref, _ = render_frames("tpu", CITY, 40, 2, tmpdir=str(tmp_path))
    b = _render_port(CITY, 40, 2, traversal="stream")
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)
    assert sorted(set(calls)) == ["any_stream", "closest_stream"]
    assert (calls.count("closest_stream"), calls.count("any_stream")) == (2 * 5, 2 * 10)
