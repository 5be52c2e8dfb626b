"""The port's two-level (TLAS+BLAS) path against the JAX package's, on two
multi-instance scenes: the bench's parity scene (16 rotated instances of
one box mesh, two materials) and a scene of three random meshes under
five rotated, scaled and translated instances (test_unified_tlas._scene).

- The port's unified tables equal the JAX package's bit for bit on its
  unpadded prefix (the JAX package pads rows that no code reaches), both
  built on one native SAH library
  (test_torch_host.jax_native_on_port_library).
- The plain two-level traversal against the XLA oracle
  (traverse_*_unified_blocked) on 1024 rays, and against the slot-lane
  Pallas kernel that B3/B4 replace, in interpret mode, on 512 rays; both
  on the same tables (convert.from_jax).
- convert.from_jax with a UnifiedPair (the wrappers' input checks are
  tests/test_torch_wrappers.py's).

Tolerances: XLA on the CPU contracts a*b+c into fused multiply-adds and
the port does not (test_torch_traverse.py), and here that rounding also
enters the object-space ray, twelve products and nine sums per instance
entry, before Möller–Trumbore magnifies it on grazing hits. That error is
absolute, on the order of the coordinates' last bits, so for hits close
to a ray's origin a relative bound alone does not hold. Measured over
32,768 rays of this file's kind (random origins inside the scenes, BVH4
table): 0 prim or instance mismatches, |dt| <= 1e-5 |t| + 1.35e-6, and
|du|, |dv| <= 2.45e-5. Gates, about twice that: t within rtol 1e-5 plus
atol 3e-6, u/v within 5e-5, and prim, instance and occlusion mismatches
at most max(2, R / 50000) lanes (the JAX bench's gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.engine import device_scene as jds
from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.ops import traverse_slotlane as tsl
from chameleonrt_tpu.ops.traverse import (
    traverse_any_unified_blocked,
    traverse_closest_unified_blocked,
)
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import convert, native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_torch_host import jax_native_on_port_library, port_scene
from test_unified_tlas import _scene as three_mesh_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

T_RTOL = 1e-5
T_ATOL = 3e-6
UV_ATOL = 5e-5
# (the JAX package's scene, the port's): from each package's loader, or the
# JAX test's scene taken over by test_torch_host.port_scene
PARITY_GRID = "proc://instances?nx=4&ny=4&subdiv=2"
SCENES = {
    "parity_grid": (lambda: jax_load_scene(PARITY_GRID), lambda: load_scene(PARITY_GRID)),
    "three_meshes": (three_mesh_scene, lambda: port_scene(three_mesh_scene())),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def tables(request):
    """(JAX blas, port blas built by the port, port blas from the JAX
    tables, JAX compute_instance_aabbs) for one scene."""
    jax_scene, scene = SCENES[request.param]
    jflat, jmeta, host = jds.build_device_scene(jax_scene(), want_host=True)
    with jax_native_on_port_library():
        jblas = jtb.build_blas_set(jflat, jmeta, host)
    flat, meta = tds.build_device_scene(scene(), torch.device("cpu"))
    port = ttb.build_blas_set(flat, meta)
    jflat_np = jax.tree.map(np.asarray, jflat)
    conv, _ = convert.from_jax(jflat_np, jmeta, jax.tree.map(np.asarray, jblas), torch.device("cpu"))
    boxes = np.asarray(jtb.compute_instance_aabbs(jflat._replace(blas=jblas), jmeta, host))
    return jblas[0], port[0], conv.blas[0], flat._replace(blas=port), boxes


def _rays(inst_aabb, R, seed):
    """Rays from inside the instances' world box in random directions, the
    first 50 inactive."""
    rng = np.random.default_rng(seed)
    lo, hi = inst_aabb[:, 0:3].min(0), inst_aabb[:, 3:6].max(0)
    orig = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.ones((R,), bool)
    active[:50] = False
    return orig, d, active


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _assert_closest_close(ref, got, R):
    t0, p0, i0, u0, v0 = (np.asarray(x) for x in ref)
    t1, p1, i1, u1, v1 = (x.numpy() for x in got)
    mism = (p0 != p1) | (i0 != i1)
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} prim/instance mismatches"
    same = ~mism
    np.testing.assert_allclose(t1[same], t0[same], rtol=T_RTOL, atol=T_ATOL)
    both = same & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)
    assert both.sum() > R // 10 and len(np.unique(i1[both])) > 1


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_unified_tables_equal_jax(tables, kind):
    """Bit for bit on the JAX tables' unpadded prefix, for the binary
    (closest) and the BVH4 (any) table."""
    jpair, port, _, _, _ = tables
    j, p = getattr(jpair, kind), getattr(port, kind)
    assert (p.n_tri_leaves, p.tlas_lo, p.stack_bound) == (j.n_tri_leaves, j.tlas_lo, j.stack_bound)
    assert p.arity == j.arity and p.leaf_size == j.leaf_size
    for name in ("nodes", "leaf_rows"):
        pa = getattr(p, name).numpy()
        ja = np.asarray(getattr(j, name))
        assert pa.shape[1] == ja.shape[1] and pa.shape[0] <= ja.shape[0]
        np.testing.assert_array_equal(pa.view(np.int32), ja[: pa.shape[0]].view(np.int32))
        assert not ja[pa.shape[0]:].any()  # the JAX package's padding
    assert p.leaf_rows.shape[0] == p.n_tri_leaves + port.inst_aabb.shape[0]


def test_instance_boxes_equal_jax(tables):
    _, port, _, flat, jboxes = tables
    np.testing.assert_array_equal(ttb.compute_instance_aabbs(flat).numpy(), jboxes)
    np.testing.assert_array_equal(port.inst_aabb.numpy(), jboxes)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_plain_closest_unified_matches_xla_oracle(tables, kind):
    jpair, _, conv, _, _ = tables
    jt, pt = getattr(jpair, kind), getattr(conv, kind)
    R = 1024
    o, d, a = _rays(conv.inst_aabb.numpy(), R, seed=11)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    ref = traverse_closest_unified_blocked(jt, *(jnp.asarray(x) for x in (o, d, tmin, a)))
    got = plain.traverse_closest_unified(pt, *_torch(o, d, tmin, a, tmax))
    _assert_closest_close(ref, got, R)
    t1, p1, i1, u1, v1 = got
    off = ~torch.from_numpy(a)
    assert (p1[off] == -1).all() and (i1[off] == -1).all() and (t1[off] == 1e20).all()
    assert (u1[off] == 0).all() and (v1[off] == 0).all()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_plain_any_unified_matches_xla_oracle(tables, kind):
    """t_max at 1.001x the closest hit (occluded, mostly by that triangle)
    and at 0.999x (walks everything in front of it)."""
    jpair, _, conv, _, _ = tables
    jt, pt = getattr(jpair, kind), getattr(conv, kind)
    R = 1024
    o, d, a = _rays(conv.inst_aabb.numpy(), R, seed=12)
    tmin = np.full((R,), 1e-4, np.float32)
    t0 = plain.traverse_closest_unified(pt, *_torch(o, d, tmin, a, np.full((R,), 1e20, np.float32)))[0]
    t0 = t0.numpy()
    for factor in (1.001, 0.999):
        tmax = np.where(t0 < 1e19, t0 * factor, 30.0).astype(np.float32)
        ref = np.asarray(traverse_any_unified_blocked(jt, *(jnp.asarray(x) for x in (o, d, tmin, tmax, a))))
        got = plain.traverse_any_unified(pt, *_torch(o, d, tmin, tmax, a)).numpy()
        assert (ref != got).sum() <= max(2, R // 50000)
        assert not got[~a].any()
        if factor > 1:
            assert got.sum() > R // 10


def test_plain_unified_matches_slotlane_interpret(tables):
    """The Pallas kernels that B3 and B4 replace, in interpret mode on the
    CPU (the suite's S=16, 8-slot shapes), on the BVH4 table they use."""
    _, _, conv, _, _ = tables
    jt = tables[0].any
    R = 512
    o, d, a = _rays(conv.inst_aabb.numpy(), R, seed=13)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 1e20, np.float32)
    jargs = [jnp.asarray(x) for x in (o, d, tmin, a)]
    ref = tsl.traverse_closest_unified_slotlane(jt, *jargs, interpret=True, S=16, k_slots=8)
    got = plain.traverse_closest_unified(conv.any, *_torch(o, d, tmin, a, tmax))
    _assert_closest_close(ref, got, R)
    t0 = got[0].numpy()
    tmax = np.where(t0 < 1e19, t0 * 1.001, 30.0).astype(np.float32)
    ref = np.asarray(tsl.traverse_any_unified_slotlane(
        jt, *(jnp.asarray(x) for x in (o, d, tmin, tmax, a)), interpret=True, S=16, k_slots=8))
    occ = plain.traverse_any_unified(conv.any, *_torch(o, d, tmin, tmax, a)).numpy()
    assert (ref != occ).sum() <= max(2, R // 50000) and occ.sum() > R // 10


def test_from_jax_carries_a_unified_pair(tables):
    jpair, _, conv, _, _ = tables
    assert isinstance(conv, tds.UnifiedPair)
    for kind in ("closest", "any"):
        j, c = getattr(jpair, kind), getattr(conv, kind)
        assert isinstance(c, tds.UnifiedBvh)
        assert (c.n_tri_leaves, c.tlas_lo, c.stack_bound) == (j.n_tri_leaves, j.tlas_lo, j.stack_bound)
        assert type(c.n_tri_leaves) is int and type(c.stack_bound) is int
        np.testing.assert_array_equal(c.nodes.numpy(), np.asarray(j.nodes))
        np.testing.assert_array_equal(c.leaf_rows.numpy(), np.asarray(j.leaf_rows))
    np.testing.assert_array_equal(conv.inst_aabb.numpy(), np.asarray(jpair.inst_aabb))

