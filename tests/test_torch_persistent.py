"""The port's work-queue persistent tier (kernels B6a-B6d, ops/traverse_cuda.py)
against the JAX package.

- The B6a/B6b wrappers (which run the plain flat traversal on CPU tensors)
  against the JAX traverse_closest_persistent / traverse_any_persistent
  that they replace, in interpret mode (the suite's K=8 slots, conftest),
  on 3000 random triangles and 4096 sorted rays: 16 packets, more than K,
  so the JAX kernels' packet swap and leaf FIFO both run.
- The B6c/B6d wrappers against traverse_closest_unified_persistent /
  traverse_any_unified_persistent on the 3x3 instance grid, 2560 sorted
  rays (10 packets).
- Both packages trace the same rows: the flat tables come from the JAX
  package's native binding over the port's library
  (test_torch_host.jax_native_on_port_library), the two-level JAX table is
  built from the port's arrays.
- The route: make_trace_fns with each kernel traversal under
  CHAMELEONRT_SLOTLANE (read as the JAX package reads it; it moves "auto"
  only), for a flat and a two-level scene; the backend passes its
  traversal on.
- The whole slice: the `cuda` backend on the CPU with traversal "persistent"
  against the JAX `tpu` backend, held to tests/test_cross_backend.py's
  _assert_images_match, on a flat and an instanced scene.
- chip_smoke.py's contract for these kernels: every launch count has a
  main path, and its output sentinels.

Tolerances are those of the port's earlier traversal tests (XLA on the CPU
fuses multiply-adds, the port does not): flat t within rtol 1e-5 and u/v
within 2e-5 (test_torch_traverse.py); two-level t within rtol 1e-5 plus
atol 3e-6 and u/v within 5e-5 (test_torch_unified.py, where the
instance-entry transform adds rounding); prims, instances and occlusion
flags equal.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu import native as jnative
from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.ops import traverse_packet as tp
from chameleonrt_tpu.ops.lbvh import PackedBvh as JaxPackedBvh
from chameleonrt_tpu.ops.lbvh import UnifiedBvh as JaxUnifiedBvh
from chameleonrt_tpu.ops.traverse import ray_sort_perm
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match, render_frames
from test_torch_host import jax_native_on_port_library
from test_torch_path_tracer import _render_port
from test_torch_route import spy_launches

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

T_RTOL = 1e-5
UV_ATOL = 2e-5
UNIFIED_T_ATOL = 3e-6
UNIFIED_UV_ATOL = 5e-5
CITY = "proc://city?n=8"
INSTANCES = "proc://instances?nx=3&ny=3&subdiv=1"
FACTORS = {"closest": None, "any_1.001": 1.001, "any_0.999": 0.999}

def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _sorted_rays(rng, R, lo, hi, n_inactive):
    """R rays from uniform origins in [lo, hi)^3 in normal-distributed
    directions, the first n_inactive inactive, in the JAX sort order."""
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = np.ones((R,), bool)
    a[:n_inactive] = False
    perm = np.asarray(ray_sort_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(a))[0])
    return o[perm], d[perm], a[perm]


@pytest.fixture(scope="module")
def flat_case():
    """(port BVH4 table, JAX BVH4 table, sorted rays) on 3000 random
    triangles (test_traverse_packet.py's clustered soup)."""
    rng = np.random.default_rng(0)
    n_tri = 3000
    centers = rng.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    v0 = centers + rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    with jax_native_on_port_library():
        _, nodes4, leaf_rows, _, stack4 = jnative.build_bvh_pair_native(v0, e1, e2, 4, wide_arity=4)
    table = tds.PackedBvh(torch.from_numpy(nodes4.copy()), torch.from_numpy(leaf_rows.copy()), stack4)
    jtable = JaxPackedBvh(jnp.asarray(nodes4), jnp.asarray(leaf_rows), max_depth=stack4)
    return table, jtable, _sorted_rays(rng, 4096, -12, 12, 100)


@pytest.fixture(scope="module")
def instances():
    """(scene, FlatScene with its tables, SceneMeta) of the 3x3 instance grid."""
    scene = load_scene(INSTANCES)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


@pytest.fixture(scope="module")
def unified_case(instances):
    """(port two-level BVH4 table, the JAX table on the same arrays, 2560
    sorted rays from inside the grid, 50 inactive)."""
    _, flat, _ = instances
    table = flat.blas[0].any
    jtable = JaxUnifiedBvh(jnp.asarray(table.nodes.numpy()), jnp.asarray(table.leaf_rows.numpy()),
                           n_tri_leaves=table.n_tri_leaves, tlas_lo=table.tlas_lo,
                           stack_bound=table.stack_bound)
    return table, jtable, _sorted_rays(np.random.default_rng(11), 2560, -5, 5, 50)


def _t_max(t, factor):
    return np.where(t < 1e19, t * factor, 30.0).astype(np.float32)


@pytest.mark.parametrize("call", sorted(FACTORS))
def test_flat_persistent_route_matches_jax_persistent_kernels(flat_case, call):
    """B6a against traverse_closest_persistent, B6b against
    traverse_any_persistent at t_max factors 1.001 and 0.999 of the port's
    closest hit (30 on a miss), both JAX kernels in interpret mode."""
    table, jtable, (o, d, a) = flat_case
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    got = traverse_cuda.traverse_closest_persistent(table, *_torch(o, d, tmin, a, tmax))
    t1, p1, u1, v1 = (x.numpy() for x in got)
    if FACTORS[call] is None:
        ref = tp.traverse_closest_persistent(jtable, *(jnp.asarray(x) for x in (o, d, tmin, a)),
                                             t_max=jnp.asarray(tmax), interpret=True)
        t0, p0, u0, v0 = (np.asarray(x) for x in ref)
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_allclose(t1, t0, rtol=T_RTOL, atol=0)
        hit = p0 >= 0
        np.testing.assert_allclose(u1[hit], u0[hit], atol=UV_ATOL)
        np.testing.assert_allclose(v1[hit], v0[hit], atol=UV_ATOL)
        assert hit.sum() > R // 10 and (p1[~a] == -1).all()
        return
    tm = _t_max(t1, FACTORS[call])
    ref = np.asarray(tp.traverse_any_persistent(
        jtable, *(jnp.asarray(x) for x in (o, d, tmin, tm, a)), interpret=True))
    occ = traverse_cuda.traverse_any_persistent(table, *_torch(o, d, tmin, tm, a)).numpy()
    np.testing.assert_array_equal(occ, ref)
    assert not occ[~a].any()
    if FACTORS[call] > 1:
        assert occ.sum() > R // 10


@pytest.mark.parametrize("call", sorted(FACTORS))
def test_unified_persistent_route_matches_jax_persistent_kernels(unified_case, call):
    """B6c against traverse_closest_unified_persistent, B6d against
    traverse_any_unified_persistent at t_max factors 1.001 and 0.999 of the
    port's closest hit (30 on a miss), interpret mode: instance entry, the
    world-ray restore and the JAX kernels' packet swap all run."""
    table, jtable, (o, d, a) = unified_case
    R = o.shape[0]
    tmin = np.zeros((R,), np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    got = traverse_cuda.traverse_closest_unified_persistent(table, *_torch(o, d, tmin, a, tmax))
    t1, p1, i1, u1, v1 = (x.numpy() for x in got)
    if FACTORS[call] is None:
        ref = tp.traverse_closest_unified_persistent(
            jtable, *(jnp.asarray(x) for x in (o, d, tmin, a)), t_max=jnp.asarray(tmax),
            interpret=True)
        t0, p0, i0, u0, v0 = (np.asarray(x) for x in ref)
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(t1, t0, rtol=T_RTOL, atol=UNIFIED_T_ATOL)
        hit = p0 >= 0
        np.testing.assert_allclose(u1[hit], u0[hit], atol=UNIFIED_UV_ATOL)
        np.testing.assert_allclose(v1[hit], v0[hit], atol=UNIFIED_UV_ATOL)
        assert hit.sum() >= 50 and len(np.unique(i1[hit])) > 1  # not a vacuous check
        assert (p1[~a] == -1).all() and (i1[~a] == -1).all()
        return
    tm = _t_max(t1, FACTORS[call])
    ref = np.asarray(tp.traverse_any_unified_persistent(
        jtable, *(jnp.asarray(x) for x in (o, d, tmin, tm, a)), interpret=True))
    occ = traverse_cuda.traverse_any_unified_persistent(table, *_torch(o, d, tmin, tm, a)).numpy()
    np.testing.assert_array_equal(occ, ref)
    assert not occ[~a].any()
    if FACTORS[call] > 1:
        assert occ.sum() >= 50


@pytest.fixture(scope="module")
def city():
    scene = load_scene(CITY)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


def _trace_once(fns, flat):
    closest, any_ = fns
    g = torch.Generator().manual_seed(3)
    o = torch.zeros((32, 3)) + 0.1
    d = torch.nn.functional.normalize(torch.randn((32, 3), generator=g), dim=1)
    active = torch.ones((32,), dtype=torch.bool)
    hit = closest(flat, o, d, 1e-4, active)
    any_(flat, o, d, torch.where(hit.tri >= 0, hit.t, torch.full_like(hit.t, 30.0)), active)


@pytest.mark.parametrize("scene", ["flat", "two_level"])
@pytest.mark.parametrize("traversal", ["auto", "lane", "stream", "persistent"])
@pytest.mark.parametrize("env", [None, "0", "off", "false", "1", "true"])
def test_make_trace_fns_routes_by_slotlane(city, instances, scene, traversal, env, monkeypatch):
    """"persistent", or "auto" under CHAMELEONRT_SLOTLANE 0 / off / false,
    routes every scene to B6a/B6b or B6c/B6d without the tier gate; "auto"
    otherwise asks the gate (a table on the CPU stays in B1-B4), and "lane"
    and "stream" keep their tiers whatever the variable says."""
    _, flat, meta = city if scene == "flat" else instances
    if env is None:
        monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    else:
        monkeypatch.setenv("CHAMELEONRT_SLOTLANE", env)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    calls = spy_launches(monkeypatch)
    queue = traversal == "persistent" or (traversal == "auto" and env in ("0", "off", "false"))
    blas = None if queue else flat.blas  # the work-queue route needs no gate
    _trace_once(ttb.make_trace_fns(meta, traversal, blas=blas), flat)
    kind = "_unified" if scene == "two_level" else ""
    tier = "_persistent" if queue else "_stream" if traversal == "stream" else ""
    assert calls == [f"closest{kind}{tier}", f"any{kind}{tier}"]


@pytest.mark.parametrize("value", ["0", "false", "off", "1", "true", "on", ""])
def test_slotlane_switch_reads_the_environment_as_the_jax_package(city, value, monkeypatch):
    """CHAMELEONRT_SLOTLANE turns "auto" to the work-queue kernels exactly
    where the JAX package's reader turns its slot-lane tier off."""
    monkeypatch.setenv("CHAMELEONRT_SLOTLANE", value)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    route = ttb.choose_route("auto", 1, False, city[1].blas[0].any)
    assert (route.closest == "closest_persistent") == (not jtb._slotlane_enabled())


def test_backend_passes_slotlane_on(instances, monkeypatch):
    """get_backend("cuda", traversal="persistent") hands its traversal to
    make_trace_fns; "auto" is the default; "plain" traces no kernel."""
    scene, _, _ = instances
    monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    calls = spy_launches(monkeypatch)
    b = get_backend("cuda", device="cpu", traversal="persistent")
    assert b.traversal == "persistent"
    b.initialize(8, 8)
    b.set_scene(scene)
    _trace_once(b._trace, b.flat)
    assert calls == ["closest_unified_persistent", "any_unified_persistent"]
    assert get_backend("cuda", device="cpu").traversal == "auto"
    plain_b = get_backend("cuda", device="cpu", traversal="plain")
    plain_b.initialize(8, 8)
    plain_b.set_scene(scene)
    _trace_once(plain_b._trace, plain_b.flat)
    assert len(calls) == 2


@pytest.mark.parametrize("uri, res, n_frames, unified", [
    (CITY, 40, 2, False),
    (INSTANCES, 40, 2, True),
])
def test_persistent_backend_frames_match_jax_tpu_backend(uri, res, n_frames, unified, tmp_path,
                                                         monkeypatch):
    """The whole slice: the cuda backend on the CPU with traversal
    "persistent" (each bounce traces through the B6 kernels' launches)
    against the JAX tpu backend."""
    calls = spy_launches(monkeypatch)
    img_ref, acc_ref, _ = render_frames("tpu", uri, res, n_frames, tmpdir=str(tmp_path))
    b = _render_port(uri, res, n_frames, traversal="persistent")
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)
    kind = "_unified" if unified else ""
    assert sorted(set(calls)) == [f"any{kind}_persistent", f"closest{kind}_persistent"]
    assert calls.count(f"closest{kind}_persistent") == 5 * n_frames
    assert calls.count(f"any{kind}_persistent") == 10 * n_frames


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_smoke_main_paths_launch_every_kernel():
    """Every launch count belongs to exactly one main path, the work-queue
    paths run with the slot-lane tier off, and each path's wrappers and
    plain versions exist."""
    cs = _chip_smoke()
    paths = cs._main_paths()
    keys = [k for *_, expect in paths.values() for k in expect]
    assert sorted(keys) == sorted(traverse_cuda.LAUNCHES)
    assert set(cs.QUEUE.values()) == {"persistent", "unified_persistent"} <= set(paths)
    assert set(cs.QUEUE) == set(cs.TIERS)
    for path in cs._PATHS:
        for closest in (True, False):
            label, kernel, plain_fn = cs._kernel_pair(path, closest)
            assert callable(kernel) and callable(plain_fn), label


def test_chip_smoke_sentinel_outputs_fill_and_restore():
    """Inside _sentinel_outputs fresh tensors hold the sentinels that
    phase 3 looks for; outside, torch.empty is itself again."""
    cs = _chip_smoke()
    empty, empty_like = torch.empty, torch.empty_like
    with cs._sentinel_outputs(torch):
        f = torch.empty((5,), dtype=torch.float32)
        i = torch.empty_like(torch.zeros((3,), dtype=torch.int32))
        b = torch.empty((4,), dtype=torch.bool)
    assert torch.isnan(f).all()
    assert (i == cs.INT_SENTINEL).all()
    assert (b.view(torch.uint8) == cs.BOOL_SENTINEL).all()
    assert torch.empty is empty and torch.empty_like is empty_like


def test_chip_smoke_holds_every_per_lane_closest_kernel_exactly():
    """Every closest-hit kernel runs the per-lane closest walk of
    csrc/traverse_common.cuh (closest_ray: B1, B5a, B6a and B7a over a flat
    table, B3, B5c and B6c over a two-level one), so chip_smoke.py holds each
    bit for bit against the plain walk (EXACT); the work-queue path's B6a
    has a main-path frame of its own (_CLOSEST_FRAME), rendered with the
    slot-lane tier off."""
    cs = _chip_smoke()
    closest = {pair[0][0] for pair in cs._PATHS.values()}
    assert closest == {"B1", "B3", "B5a", "B5c", "B6a", "B6c", "B7a"}
    assert closest <= set(cs.EXACT)
    assert cs._CLOSEST_FRAME["persistent"] == {"traversal": "persistent"}
    assert {cs._PATHS[p][0][0] for p in cs._CLOSEST_FRAME} == {"B1", "B5a", "B6a", "B7a"}


def test_chip_smoke_holds_every_per_lane_any_kernel_exactly():
    """Every any-hit kernel runs the per-lane any walk of
    csrc/traverse_common.cuh (any_ray: B2, B5b, B6b and B7b over a flat
    table, B4, B5d and B6d over a two-level one), so chip_smoke.py holds
    each bit for bit against the plain walk (EXACT); the work-queue paths,
    whose main-path frames _check_any_shadow renders with the slot-lane
    tier off, are B6b's and B6d's."""
    cs = _chip_smoke()
    any_hit = {pair[1][0] for pair in cs._PATHS.values()}
    assert any_hit == {"B2", "B4", "B5b", "B5d", "B6b", "B6d", "B7b"}
    assert any_hit <= set(cs.EXACT)
    assert {cs._PATHS[p][1][0] for p in set(cs.QUEUE.values())} == {"B6b", "B6d"}
