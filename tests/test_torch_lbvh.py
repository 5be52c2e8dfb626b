"""The port's LBVH fallback (chameleonrt_tpu_torch/ops/lbvh.py and the
no-builder branches of engine/trace_bvh.py) against the JAX package's
(chameleonrt_tpu/ops/lbvh.py, chameleonrt_tpu/engine/trace_bvh.py).

- triangle_aabbs, morton_codes, _clz32, build_bvh and pack_bvh bit-equal
  to JAX on seeded soups: one triangle, fewer than a leaf, a count that is
  not a multiple of the leaf size, runs of duplicate Morton codes, and a
  few thousand triangles; the port's max_depth (JAX's is None) is the
  tree's height, counted here from JAX's child arrays.
- The plain walks over the port's LBVH against the XLA oracle's
  (traverse_closest_blocked / traverse_any_blocked) over JAX's, at
  tests/test_torch_traverse.py's flat tolerance (XLA on the CPU fuses
  multiply-adds, the port does not), and on a table deep enough to
  overflow the 48-entry stack, where both report prim = -2 (closest) and
  occluded (any) on the same lanes.
- With native.get_lib() None: build_blas_set gives LBVH BlasPairs (one
  table in both slots, max_depth its height), and make_trace_fns routes
  them through the flat kernels, as a native table of the same scene (the
  "auto", "stream", "persistent" and "packet" routes; a multi-instance
  scene one launch an instance).
- A 2x2-instance frame with no native builder against the JAX `tpu`
  backend with its native.get_lib patched to None (in the JAX frame's own
  process, tests/subproc_render.py says why), under
  tests/test_cross_backend.py's _assert_images_match.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.engine.device_scene import build_device_scene as jax_build_device_scene
from chameleonrt_tpu.ops import lbvh as jl
from chameleonrt_tpu.ops.lbvh import PackedBvh as JaxPackedBvh
from chameleonrt_tpu.ops.traverse import (
    ray_sort_perm,
    traverse_any_blocked,
    traverse_closest_blocked,
)
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import trace_bvh
from chameleonrt_tpu_torch.engine.device_scene import BlasPair, PackedBvh, build_device_scene
from chameleonrt_tpu_torch.ops import lbvh as tl
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_RTOL = 1e-5
UV_ATOL = 2e-5
T_MAX = 1e20
FLAT = "proc://cornell"
INSTANCED = "proc://instances?nx=2&ny=2&subdiv=0"
FRAME_RES, FRAME_N = 32, 2


def _soup(n_tri, seed, dup=0):
    """Seeded triangles in a box; the first dup of them share one triangle
    (equal centroids, so equal Morton codes)."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    e1 = r.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = r.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    for a in (v0, e1, e2):
        a[:dup] = a[0]
    return v0, e1, e2


# (triangles, seed, duplicates): one triangle, fewer than a leaf (4), not a
# multiple of 4, runs of equal codes (a half, and all), a few thousand
SOUPS = {
    "one": (1, 1, 0),
    "below_leaf": (3, 2, 0),
    "not_multiple": (10, 3, 0),
    "duplicates_half": (301, 4, 150),
    "duplicates_all": (64, 5, 64),
    "thousands": (3001, 6, 0),
}


def _both(v0, e1, e2):
    """(JAX PackedBvh, JAX Bvh, port PackedBvh, port Bvh) over the same
    triangles."""
    jv = tuple(jnp.asarray(x) for x in (v0, e1, e2))
    tv = tuple(torch.from_numpy(x) for x in (v0, e1, e2))
    jb = jl.build_bvh(*jl.triangle_aabbs(*jv))
    tb = tl.build_bvh(*tl.triangle_aabbs(*tv))
    return jl.pack_bvh(jb, *jv), jb, tl.pack_bvh(tb, *tv), tb


def _height(bvh) -> int:
    """Internal nodes on the longest root-to-leaf path of a JAX Bvh,
    walked from the root on the host."""
    left, right = np.asarray(bvh.node_left), np.asarray(bvh.node_right)
    n_internal = (left.shape[0] + 1) // 2 - 1
    best, todo = 0, [(0, 1)] if n_internal else []
    while todo:
        node, depth = todo.pop()
        best = max(best, depth)
        todo += [(c, depth + 1) for c in (left[node], right[node]) if c < n_internal]
    return best


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


@pytest.mark.parametrize("case", sorted(SOUPS))
def test_lbvh_tables_bit_equal_jax(case):
    n, seed, dup = SOUPS[case]
    v0, e1, e2 = _soup(n, seed, dup)
    jmin, jmax = jl.triangle_aabbs(*(jnp.asarray(x) for x in (v0, e1, e2)))
    tmin, tmax = tl.triangle_aabbs(*(torch.from_numpy(x) for x in (v0, e1, e2)))
    np.testing.assert_array_equal(_bits(tmin.numpy()), _bits(np.asarray(jmin)))
    np.testing.assert_array_equal(_bits(tmax.numpy()), _bits(np.asarray(jmax)))
    cent = 0.5 * (tmin + tmax)
    codes = tl.morton_codes(cent, tmin.min(dim=0).values, tmax.max(dim=0).values)
    jcodes = jl.morton_codes(0.5 * (jmin + jmax), jmin.min(axis=0), jmax.max(axis=0))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int64))
    if dup:
        assert len(np.unique(codes.numpy()[:dup])) == 1
    jp, jb, tp, tb = _both(v0, e1, e2)
    for field in jb._fields:
        np.testing.assert_array_equal(_bits(getattr(tb, field).numpy()),
                                      _bits(np.asarray(getattr(jb, field))), err_msg=field)
    np.testing.assert_array_equal(_bits(tp.nodes.numpy()), _bits(np.asarray(jp.nodes)))
    np.testing.assert_array_equal(_bits(tp.leaf_rows.numpy()), _bits(np.asarray(jp.leaf_rows)))
    assert jp.max_depth is None and tp.max_depth == tb.height == _height(jb)
    assert tp.nodes.shape[1] == 16 and tp.leaf_size == tl.LEAF_SIZE


def test_clz32_matches_jax():
    r = np.random.default_rng(9)
    x = np.concatenate([
        np.array([0, 1, 2, 3, 0x3FFFFFFF, 0x40000000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]),
        r.integers(0, 1 << 32, 2000), 1 << r.integers(0, 32, 200),
    ]).astype(np.uint32)
    got = tl._clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl._clz32(jnp.asarray(x))))


@pytest.fixture(scope="module")
def walk_case():
    """tests/test_torch_traverse.py's rays over both packages' LBVH of a
    3000-triangle soup: 2048 rays, 60 inactive, sorted."""
    v0, e1, e2 = _soup(3000, 7)
    jp, _, tp, _ = _both(v0, e1, e2)
    rng = np.random.default_rng(8)
    n_rays = 2048
    orig = jnp.asarray(rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    active = jnp.ones((n_rays,), bool).at[:60].set(False)
    perm, _ = ray_sort_perm(orig, d, active)
    return jp, tp, tuple(np.asarray(x[perm]) for x in (orig, d, active))


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def test_plain_closest_over_lbvh_matches_xla_oracle(walk_case):
    jp, tp, (o, d, a) = walk_case
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    t0, p0, u0, v0 = (np.asarray(x) for x in traverse_closest_blocked(jp, o, d, jnp.asarray(tmin), a))
    t1, p1, u1, v1 = (x.numpy() for x in plain.traverse_closest(tp, *_torch(o, d, tmin, a)))
    mism = p0 != p1
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} prim mismatches"
    np.testing.assert_allclose(t1[~mism], t0[~mism], rtol=T_RTOL, atol=0)
    both = ~mism & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)
    assert 0 < (p1 >= 0).sum() and not (p1 == -2).any()
    assert (p1[~a] == -1).all()


@pytest.mark.parametrize("factor", [1.001, 0.999])
def test_plain_any_over_lbvh_matches_xla_oracle(walk_case, factor):
    jp, tp, (o, d, a) = walk_case
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    t0 = np.asarray(traverse_closest_blocked(jp, o, d, jnp.asarray(tmin), a)[0])
    tmax = np.where(t0 < 1e19, t0 * factor, 30.0).astype(np.float32)
    ref = np.asarray(traverse_any_blocked(jp, o, d, jnp.asarray(tmin), jnp.asarray(tmax), a))
    got = plain.traverse_any(tp, *_torch(o, d, tmin, tmax, a)).numpy()
    assert (ref != got).sum() <= max(2, R // 50000)
    assert not got[~a].any()
    assert (got.sum() > 0) == (factor > 1)


def _chain_table(levels):
    """A binary table of the LBVH layout (max_depth `levels`) that is a chain
    of `levels` internal rows along +z: row k holds leaf k (one triangle
    across the z axis at z = 100 + k) and row k + 1, whose box starts
    nearer, so a ray down the axis pushes leaf k at every row and needs a
    stack of `levels` entries. Returns (nodes, leaf_rows) as numpy."""
    L = tl.LEAF_SIZE
    n_leaves = levels + 1
    leaf = np.zeros((n_leaves, 10 * L), np.float32)
    pid = leaf[:, 9 * L : 10 * L].view(np.int32)
    pid[:] = -1
    for k in range(n_leaves):
        z = 100.0 + k
        tri = (-1.0, -1.0, z, 3.0, 0.0, 0.0, 0.0, 3.0, 0.0)  # v0, e1, e2
        for c, val in enumerate(tri):
            leaf[k, c * L] = val
        pid[k, 0] = k
    nodes = np.zeros((levels, 16), np.float32)
    codes = nodes[:, 12:14].view(np.int32)
    for k in range(levels):
        nodes[k, 0:6] = (-1, -1, 100 + k, 2, 2, 100 + k)  # leaf k's box
        if k + 1 < levels:
            nodes[k, 6:12] = (-2, -2, k + 1, 2, 2, 200)  # row k + 1, entered nearer
            codes[k] = (-k - 1, k + 1)
        else:
            nodes[k, 6:12] = (-1, -1, 100 + k + 1, 2, 2, 100 + k + 1)
            codes[k] = (-k - 1, -(k + 1) - 1)
    return nodes, leaf


def test_deep_lbvh_overflows_48_like_jax():
    """Past STACK_DEPTH = 48 both walks poison the lane: prim -2 at
    t = T_MAX (closest), occluded (any); lanes that stay shallow agree."""
    nodes, leaf = _chain_table(60)
    jp = JaxPackedBvh(jnp.asarray(nodes), jnp.asarray(leaf), max_depth=None)
    tp = PackedBvh(torch.from_numpy(nodes), torch.from_numpy(leaf), 60)
    assert plain.stack_limit(tp) == plain.STACK_DEPTH == 48
    # lanes 0-3 run down the axis from below every triangle (59 pushes);
    # 4-7 from past z = 120, so at most 39 leaves lie ahead; 8 misses every
    # box; 9 and 10 pass every leaf box but miss its triangle, 9 from below
    # every triangle (an overflow with no hit), 10 from past z = 120
    xy = [(0.25, 0.25)] * 8 + [(50.0, 0.25), (1.5, 1.5), (1.5, 1.5)]
    z = [0, -5, 1, 2, 120.5, 130.5, 140.5, 150.5, 0, 0, 120.5]
    o = np.array([(x, y, zz) for (x, y), zz in zip(xy, z)], np.float32)
    R = o.shape[0]
    d = np.tile(np.array([[0, 0, 1]], np.float32), (R, 1))
    a = np.ones((R,), bool)
    tmin = np.zeros((R,), np.float32)
    t0, p0, _, _ = (np.asarray(x) for x in traverse_closest_blocked(jp, o, d, jnp.asarray(tmin), a))
    t1, p1, _, _ = (x.numpy() for x in plain.traverse_closest(tp, *_torch(o, d, tmin, a)))
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(t1, t0)
    np.testing.assert_array_equal(p1, [-2, -2, -2, -2, 21, 31, 41, 51, -1, -2, -1])
    assert (t1[p1 < 0] == np.float32(T_MAX)).all()
    tmax = np.full((R,), 1e3, np.float32)
    ref = np.asarray(traverse_any_blocked(jp, o, d, jnp.asarray(tmin), jnp.asarray(tmax), a))
    got = plain.traverse_any(tp, *_torch(o, d, tmin, tmax, a)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [True] * 8 + [False, True, False])


def _no_builder(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _flat_scene(uri, monkeypatch):
    _no_builder(monkeypatch)
    flat, meta = build_device_scene(load_scene(uri), torch.device("cpu"))
    flat = flat._replace(blas=trace_bvh.build_blas_set(flat, meta))
    if meta.num_instances > 1:
        flat = flat._replace(inst_aabb=trace_bvh.compute_instance_aabbs(flat, meta))
    return flat, meta


@pytest.mark.parametrize("uri", [FLAT, INSTANCED])
def test_build_blas_set_without_builder_gives_lbvh_pairs(uri, monkeypatch):
    flat, meta = _flat_scene(uri, monkeypatch)
    assert len(flat.blas) == len(meta.mesh_tri_ranges)
    for pair, (start, count) in zip(flat.blas, meta.mesh_tri_ranges):
        assert isinstance(pair, BlasPair) and pair.closest is pair.any
        assert pair.closest.arity == 2 and 1 <= pair.closest.max_depth <= 62
        depth = pair.closest.max_depth + 1
        assert plain.stack_limit(pair.closest) == min(48, depth)
        assert traverse_cuda.stack_depth(pair.closest) == depth
        assert traverse_cuda.stack_capacity(depth) == 64
        ids = pair.closest.leaf_rows[:, 9 * 4 : 10 * 4].contiguous().view(torch.int32)
        assert sorted(ids[ids >= 0].tolist()) == list(range(count))  # local, unpadded
        sl = slice(start, start + count)
        want = tl.build_packed(flat.tri_v0[sl], flat.tri_e1[sl], flat.tri_e2[sl])
        assert torch.equal(pair.closest.nodes.view(torch.int32), want.nodes.view(torch.int32))
        assert pair.closest.max_depth == want.max_depth


def test_instance_boxes_over_lbvh_equal_jax(monkeypatch):
    flat, meta = _flat_scene(INSTANCED, monkeypatch)
    jflat, jmeta, host = jax_build_device_scene(jax_load_scene(INSTANCED), want_host=True)
    want = np.asarray(jtb.compute_instance_aabbs(jflat, jmeta, host))
    np.testing.assert_array_equal(flat.inst_aabb.numpy(), want)
    with pytest.raises(ValueError, match="meta"):
        trace_bvh.compute_instance_aabbs(flat)


# make_trace_fns's traversal, and the suffix of the KERNELS keys it picks
ROUTES = {
    "default": ("auto", ""),
    "stream": ("stream", "_stream"),
    "queue": ("persistent", "_persistent"),
    "grid_packet": ("packet", "_packet"),
}


@pytest.mark.parametrize("uri", [FLAT, INSTANCED])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_lbvh_tables_take_the_kernel_route(uri, route, monkeypatch):
    """LBVH tables: every walk is one launch of the flat kernel that the
    traversal picks (B1/B2, B5a/B5b, B6a/B6b or B7a/B7b; on the CPU it
    runs the plain walk), one launch an instance in a multi-instance
    scene, each on a table whose certified stack the kernels take; no
    two-level kernel is launched."""
    flat, meta = _flat_scene(uri, monkeypatch)
    for k in ("CHAMELEONRT_SLOTLANE", "CHAMELEONRT_PACKET"):
        monkeypatch.delenv(k, raising=False)
    multi = meta.num_instances > 1
    traversal, suffix = ROUTES[route]
    if multi and route == "grid_packet":
        with pytest.raises(ValueError, match="flat scenes only"):
            trace_bvh.make_trace_fns(meta, "packet", blas=flat.blas)
        return
    calls = []
    for name in ("launch_closest", "launch_any"):
        def record(key, table, *args, _real=getattr(traverse_cuda, name)):
            calls.append(key)
            assert traverse_cuda.stack_depth(table) == table.max_depth + 1
            return _real(key, table, *args)

        monkeypatch.setattr(traverse_cuda, name, record)
    closest, any_ = trace_bvh.make_trace_fns(meta, traversal, blas=flat.blas)
    R = 64
    r = np.random.default_rng(3)
    o = torch.from_numpy(r.uniform(-0.5, 0.5, (R, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(R, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    active = torch.ones(R, dtype=torch.bool)
    hit = closest(flat, o, d, 0.0, active)
    occ = any_(flat, o, d, torch.full((R,), 1e3), active)
    assert hit.tri.dtype == torch.int32 and hit.inst.dtype == torch.int32
    assert (hit.tri >= 0).any() and occ.any()
    walks = len(meta.inst_mesh) if multi else 1
    assert calls == [f"closest{suffix}"] * walks + [f"any{suffix}"] * walks


def test_instanced_frame_without_builder_matches_jax(monkeypatch, tmp_path):
    """One JAX `tpu` frame pair with no native builder (per-mesh LBVHs,
    the unrolled instance loop) against the port's."""
    out = tmp_path / "jax.npz"
    script = (
        "import sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import chameleonrt_tpu.native as jn\n"
        "jn.get_lib = lambda: None\n"
        "from tests.subproc_render import main\n"
        "main(sys.argv[1:])\n"
    )
    subprocess.run([sys.executable, "-c", script, "tpu", INSTANCED, str(FRAME_RES), str(FRAME_N),
                    str(out)], cwd=ROOT, check=True, timeout=600)
    with np.load(out) as z:
        img_ref, acc_ref = z["img"].copy(), z["accum"].copy()
    _no_builder(monkeypatch)
    scene = load_scene(INSTANCED)
    b = get_backend("cuda", device="cpu")
    b.initialize(FRAME_RES, FRAME_RES)
    b.set_scene(scene)
    assert all(isinstance(p, BlasPair) and p.closest is p.any for p in b.flat.blas)
    cam = scene.cameras[0]
    d = cam.center - cam.position
    for i in range(FRAME_N):
        b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, i == 0,
                 readback_framebuffer=(i == FRAME_N - 1))
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)


def test_cuda_backend_names_its_tables(monkeypatch):
    """The CLI prints the backend's name before set_scene: it says which
    tables set_scene will build, from the compiler's lookup alone (the
    native library is neither built nor loaded)."""
    def no_build():
        raise AssertionError("the backend's name built the native library")

    monkeypatch.setattr(native, "get_lib", no_build)
    b = get_backend("cuda", device="cpu")
    monkeypatch.setenv("CXX", sys.executable)  # a program that PATH lookup finds
    assert b.name == "CUDA wavefront (SAH BVH4)"
    monkeypatch.setenv("CXX", "crt-no-such-c++-compiler")
    assert b.name == "CUDA wavefront (LBVH: no native builder)"
