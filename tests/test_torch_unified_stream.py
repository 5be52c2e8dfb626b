"""The port's two-level streamed tier (kernels B5c/B5d, ops/traverse_cuda.py)
against the JAX package.

- The B5c/B5d wrappers (which run the plain two-level traversal on CPU
  tensors) against the JAX stream=True unified slot-lane kernels that they
  replace, in interpret mode (the suite's S=16, 8-slot shapes), on a
  sorted camera wavefront and a diffuse-bounce wavefront at 64x36 of two
  scenes: the 2x2 instance grid and the tiny San Miguel (89 instances of
  7 meshes, loaded through each package's own generator and PBRT loader).
- The routing of make_trace_fns for a multi-instance scene under
  traversal "auto", "stream" and "lane", with the L2's size set.
- The plain walk's optional counter (ops/traverse.py WalkCount), which
  gives chip_smoke.py the kernels' least times.
- The whole slice: the `cuda` backend on the CPU with traversal "stream" on a
  two-level scene against the JAX `tpu` backend, held to
  tests/test_cross_backend.py's _assert_images_match.

Tolerances are those of test_torch_unified.py (XLA on the CPU fuses
multiply-adds, the port does not, and the instance-entry transform adds to
it): t within rtol 1e-5 plus atol 3e-6, u/v within 5e-5, prim and
instance mismatches at most max(2, R / 50000) lanes; occlusion flags at
t_max factors 1.001 and 0.999 equal on every lane whose closest hit agrees.
On the tiny San Miguel's bounce wavefront one lane differs in both: a ray
leaving a leaf whose XLA-fused t of 1.078e-4 clears t_min = 1e-4 where the
port's unfused t does not (ROADMAP section C: the instance-entry transform
adds CPU rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.ops import camera as jcam
from chameleonrt_tpu.ops import rng as jrng
from chameleonrt_tpu.ops import traverse_slotlane as tsl
from chameleonrt_tpu.ops.lbvh import UnifiedBvh as JaxUnifiedBvh
from chameleonrt_tpu.ops.traverse import ray_sort_perm_only as jax_sort_perm
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.scene.pbrt_gen import generate_san_miguel_proxy
from test_cross_backend import _assert_images_match, render_frames
from test_torch_host import TINY_SAN_MIGUEL
from test_torch_path_tracer import _camera, _render_port
from test_torch_route import l2_of, spy_launches

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

T_RTOL = 1e-5
T_ATOL = 3e-6
UV_ATOL = 5e-5
INSTANCES = "proc://instances?nx=2&ny=2&subdiv=0"
W, H = 64, 36


def _scene(name, tmp_path_factory):
    if name == "instances":
        return load_scene(INSTANCES)
    out = tmp_path_factory.mktemp("san_miguel_tiny")
    return load_scene(generate_san_miguel_proxy(str(out), **TINY_SAN_MIGUEL))


@pytest.fixture(scope="module", params=["instances", "san_miguel_tiny"])
def two_level(request, tmp_path_factory):
    """(scene, FlatScene with its two-level tables, SceneMeta)."""
    scene = _scene(request.param, tmp_path_factory)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    assert meta.num_instances > 1
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


@pytest.fixture(scope="module")
def wavefronts(two_level):
    """The JAX table built from the port's BVH4 arrays, and two sorted
    world-space wavefronts: the camera's primary rays at 64x36 and diffuse
    bounces from their hits (uniform in the hemisphere of the world face
    normal that faces the incoming ray, numpy seed 23; lanes that missed
    are inactive)."""
    scene, flat, _ = two_level
    table = flat.blas[0].any
    jtable = JaxUnifiedBvh(jnp.asarray(table.nodes.numpy()), jnp.asarray(table.leaf_rows.numpy()),
                           n_tri_leaves=table.n_tri_leaves, tlas_lo=table.tlas_lo,
                           stack_bound=table.stack_bound)
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
    t, prim, inst, _, _ = plain.traverse_closest_unified(
        table, *_torch(o, dd, np.zeros(R, np.float32), a), torch.full((R,), 1e20))
    hit = prim.numpy() >= 0
    p = o + np.where(hit, t.numpy(), 0.0)[:, None].astype(np.float32) * dd
    _, e1, e2 = tds.host_triangles(flat)
    k = np.maximum(prim.numpy(), 0)
    n = np.cross(e1[k], e2[k])
    inv3 = flat.inst_inv.numpy()[np.maximum(inst.numpy(), 0), :3, :3]
    n = np.einsum("rji,rj->ri", inv3, n)  # object normal to world: inverse transpose
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where((np.sum(n * dd, axis=1) > 0)[:, None], -n, n)
    w = np.random.default_rng(23).normal(size=(R, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w = np.where((np.sum(w * n, axis=1) < 0)[:, None], -w, w)
    p, w = p.astype(np.float32), w.astype(np.float32)
    perm = np.asarray(jax_sort_perm(jnp.asarray(p), jnp.asarray(w), jnp.asarray(hit)))
    bounce = (p[perm], w[perm], hit[perm])
    return table, jtable, {"primary": (primary, 0.0), "bounce": (bounce, 1e-4)}


@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_unified_stream_route_matches_jax_stream_kernels(wavefronts, wave):
    """B5c's and B5d's wrappers (the plain version on the CPU) against
    traverse_closest_unified_slotlane / traverse_any_unified_slotlane with
    stream=True in interpret mode: closest hit, then any hit at t_max
    factors 1.001 and 0.999 of the closest hit (30 on a miss)."""
    table, jtable, waves = wavefronts
    (o, d, a), t_min = waves[wave]
    R = o.shape[0]
    tmin = np.full((R,), t_min, np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    ref = tsl.traverse_closest_unified_slotlane(
        jtable, *(jnp.asarray(x) for x in (o, d, tmin, a)), t_max=jnp.asarray(tmax),
        interpret=True, S=16, k_slots=8, stream=True,
    )
    got = traverse_cuda.traverse_closest_unified_stream(table, *_torch(o, d, tmin, a, tmax))
    t0, p0, i0, u0, v0 = (np.asarray(x) for x in ref)
    t1, p1, i1, u1, v1 = (x.numpy() for x in got)
    mism = (p0 != p1) | (i0 != i1)
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} prim/instance mismatches"
    same = ~mism
    np.testing.assert_allclose(t1[same], t0[same], rtol=T_RTOL, atol=T_ATOL)
    both = same & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)
    assert both.sum() >= 20 and len(np.unique(i1[both])) > 1  # not a vacuous check
    assert (p1[~a] == -1).all() and (i1[~a] == -1).all()
    for factor in (1.001, 0.999):
        tm = np.where(t1 < 1e19, t1 * factor, 30.0).astype(np.float32)
        ref = np.asarray(tsl.traverse_any_unified_slotlane(
            jtable, *(jnp.asarray(x) for x in (o, d, tmin, tm, a)),
            interpret=True, S=16, k_slots=8, stream=True,
        ))
        occ = traverse_cuda.traverse_any_unified_stream(table, *_torch(o, d, tmin, tm, a)).numpy()
        # equal except on a lane whose closest hit already differs
        assert not (occ != ref)[same].any()
        assert (occ != ref).sum() <= max(2, R // 50000)
        assert not occ[~a].any()
        if factor > 1:
            assert occ.sum() >= 20


@pytest.mark.parametrize(
    "traversal, l2_fits, want",
    [
        ("auto", False, "stream"),
        ("auto", True, "vmem"),
        ("stream", True, "stream"),
        ("lane", False, "vmem"),
    ],
)
def test_make_trace_fns_routes_two_level_scenes_by_tier(two_level, traversal, l2_fits, want,
                                                        monkeypatch):
    """The kernels the returned trace functions launch for a
    multi-instance scene, for each traversal, with the L2 budget just
    above or just below the two-level BVH4 table."""
    _, flat, meta = two_level
    monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    calls = spy_launches(monkeypatch)
    n = ttb.table_bytes(flat.blas[0].any)
    l2_of(monkeypatch, n if l2_fits else n - 1)
    closest, any_ = ttb.make_trace_fns(meta, traversal, blas=flat.blas)
    o = torch.zeros((32, 3))
    d = torch.nn.functional.normalize(torch.randn((32, 3), generator=torch.Generator().manual_seed(3)), dim=1)
    active = torch.ones((32,), dtype=torch.bool)
    hit = closest(flat, o, d, 1e-4, active)
    any_(flat, o, d, torch.where(hit.tri >= 0, hit.t, torch.full_like(hit.t, 30.0)), active)
    suffix = "_stream" if want == "stream" else ""
    assert calls == ["closest_unified" + suffix, "any_unified" + suffix]


def test_streamed_tier_gate_reads_two_level_tables(two_level):
    _, flat, _ = two_level
    table = flat.blas[0].any
    n = ttb.table_bytes(table)
    assert n == (table.nodes.shape[0] * 32 + table.leaf_rows.shape[0] * 40) * 4
    assert ttb.streamed_tier(table, l2_bytes=n - 1)
    assert not ttb.streamed_tier(table, l2_bytes=n)
    assert not ttb.streamed_tier(table)  # a table on the CPU has no L2


def test_walk_count_counts_what_the_rays_need(wavefronts):
    """Tracing every ray twice doubles every visit and keeps the distinct
    rows; an inactive wavefront visits nothing; the counter does not change
    the result."""
    table, _, waves = wavefronts
    (o, d, a), _ = waves["primary"]
    R = o.shape[0]
    args = _torch(o, d, np.zeros(R, np.float32), a, np.full(R, 1e20, np.float32))
    one, two, none = plain.WalkCount(table), plain.WalkCount(table), plain.WalkCount(table)
    res = plain.traverse_closest_unified(table, *args, count=one)
    assert all(torch.equal(x, y) for x, y in zip(res, plain.traverse_closest_unified(table, *args)))
    plain.traverse_closest_unified(table, *(torch.cat([x, x]) for x in args), count=two)
    plain.traverse_closest_unified(table, args[0], args[1], args[2], torch.zeros_like(args[3]),
                                   args[4], count=none)
    c1, c2 = one.totals(), two.totals()
    assert c1["node_visits"] > int(a.sum())
    assert c1["leaf_visits"] > 0 and c1["entry_visits"] > 0
    assert 0 < c1["entry_rows"] <= table.leaf_rows.shape[0] - table.n_tri_leaves
    for k in ("node_visits", "leaf_visits", "entry_visits", "slab_tests", "mt_slots"):
        assert c2[k] == 2 * c1[k], k
    for k in ("node_rows", "leaf_rows", "entry_rows"):
        assert c2[k] == c1[k], k
    assert none.totals() == {k: 0 for k in c1}
    # only live children and valid slots are tested: each live child slot
    # names a distinct row, and some rows and leaves are not full
    L = table.leaf_rows.shape[1] // 10
    assert c1["node_visits"] <= c1["slab_tests"] < 4 * c1["node_visits"]
    assert c1["leaf_visits"] <= c1["mt_slots"] < L * c1["leaf_visits"]
    live = table.nodes[:, 0:24:6] < 1e30
    codes = table.nodes.view(torch.int32)[:, 24:28][live]
    assert codes.unique().numel() == codes.numel() == int(one.live_children.sum())


def test_unified_stream_backend_frames_match_jax_tpu_backend(tmp_path, monkeypatch):
    """The whole slice on a two-level scene: the cuda backend on the CPU
    with traversal "stream" (each bounce traces through B5c/B5d's
    launches) against the JAX tpu backend, 40 px x 2 frames."""
    calls = spy_launches(monkeypatch)
    uri = "proc://instances?nx=3&ny=3&subdiv=1"
    img_ref, acc_ref, _ = render_frames("tpu", uri, 40, 2, tmpdir=str(tmp_path))
    b = _render_port(uri, 40, 2, traversal="stream")
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)
    assert sorted(set(calls)) == ["any_unified_stream", "closest_unified_stream"]
    assert (calls.count("closest_unified_stream"), calls.count("any_unified_stream")) == (10, 20)
