"""The port's plain traversal (chameleonrt_tpu_torch/ops/traverse.py) against
the JAX package's XLA oracle and its slot-lane Pallas kernel in interpret
mode, on the same tables (native SAH build) and the same rays.

Tolerance: XLA on the CPU contracts a*b+c into fused multiply-adds and the
port does not (torch's CPU kernels, and nvcc -fmad=false on the card), so
t may differ in the last bits, and cancellation in the Möller–Trumbore dot
products magnifies that: t within rtol 1e-5 (measured: 1e-6). Prim ids
must agree except for rays whose two nearest candidates lie within that
rounding of each other: at most max(2, R / 50000) lanes, the JAX bench's
gate. u/v within 2e-5: they divide by the determinant, which magnifies the
same rounding on grazing triangles (measured: 1.01e-5 on one lane).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chameleonrt_tpu.ops import traverse_slotlane as tsl
from chameleonrt_tpu.ops import intersect as jint
from chameleonrt_tpu.ops.lbvh import PackedBvh as JaxPackedBvh
from chameleonrt_tpu.ops.traverse import (
    ray_sort_perm,
    ray_sort_perm_only as jax_sort_perm,
    traverse_any_blocked,
    traverse_closest_blocked,
)
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh
from chameleonrt_tpu_torch.ops import intersect as tint
from chameleonrt_tpu_torch.ops import traverse as plain

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

T_RTOL = 1e-5
UV_ATOL = 2e-5


@pytest.fixture(scope="module")
def scene_and_rays():
    """tests/test_traverse_slotlane.py's fixture: 3000 triangles, 2048 rays,
    60 inactive, sorted."""
    rng = np.random.default_rng(7)
    n_tri, n_rays = 3000, 2048
    centers = rng.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    v0 = centers + rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    nodes2, nodes4, leaf_rows, depth2, depth4 = native.build_bvh_pair_native(v0, e1, e2, 4)
    jax_bvh = {
        2: JaxPackedBvh(jnp.asarray(nodes2), jnp.asarray(leaf_rows), max_depth=depth2),
        4: JaxPackedBvh(jnp.asarray(nodes4), jnp.asarray(leaf_rows), max_depth=depth4),
    }
    leaf = torch.from_numpy(leaf_rows)
    port_bvh = {
        2: PackedBvh(torch.from_numpy(nodes2), leaf, depth2),
        4: PackedBvh(torch.from_numpy(nodes4), leaf, depth4),
    }
    orig = jnp.asarray(rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    active = jnp.ones((n_rays,), bool).at[:60].set(False)
    perm, _ = ray_sort_perm(orig, d, active)
    rays = tuple(np.asarray(x[perm]) for x in (orig, d, active))
    return jax_bvh, port_bvh, rays


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _assert_closest_close(ref, got, R):
    t0, p0, u0, v0 = (np.asarray(x) for x in ref)
    t1, p1, u1, v1 = (x.numpy() for x in got)
    mism = p0 != p1
    assert mism.sum() <= max(2, R // 50000), f"{mism.sum()} prim mismatches"
    same = ~mism
    np.testing.assert_allclose(t1[same], t0[same], rtol=T_RTOL, atol=0)
    both = same & (p0 >= 0)
    np.testing.assert_allclose(u1[both], u0[both], atol=UV_ATOL)
    np.testing.assert_allclose(v1[both], v0[both], atol=UV_ATOL)
    assert (p1 >= 0).sum() > 0


@pytest.mark.parametrize("arity", [2, 4])
def test_plain_closest_matches_xla_oracle(scene_and_rays, arity):
    jax_bvh, port_bvh, (o, d, a) = scene_and_rays
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    ref = traverse_closest_blocked(jax_bvh[arity], o, d, jnp.asarray(tmin), a)
    got = plain.traverse_closest(port_bvh[arity], *_torch(o, d, tmin, a))
    _assert_closest_close(ref, got, R)
    # inactive lanes are clean misses
    t1, p1, u1, v1 = got
    off = ~torch.tensor(a)
    assert (p1[off] == -1).all() and (t1[off] == 1e20).all()


@pytest.mark.parametrize("arity", [2, 4])
def test_plain_any_matches_xla_oracle(scene_and_rays, arity):
    jax_bvh, port_bvh, (o, d, a) = scene_and_rays
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    t0, _, _, _ = traverse_closest_blocked(jax_bvh[2], o, d, jnp.asarray(tmin), a)
    t0 = np.asarray(t0)
    for factor in (1.001, 0.999):
        tmax = np.where(t0 < 1e19, t0 * factor, 30.0).astype(np.float32)
        ref = np.asarray(traverse_any_blocked(jax_bvh[arity], o, d, jnp.asarray(tmin), jnp.asarray(tmax), a))
        got = plain.traverse_any(port_bvh[arity], *_torch(o, d, tmin, tmax, a)).numpy()
        assert (ref != got).sum() <= max(2, R // 50000)
        assert not got[~a].any()
        if factor > 1:
            assert got.sum() > 0


def test_plain_closest_matches_slotlane_interpret(scene_and_rays):
    """The Pallas kernel that B1 replaces, run in interpret mode on the CPU
    (the suite's S=16, 8-slot shapes), on the BVH4 table it uses."""
    jax_bvh, port_bvh, (o, d, a) = scene_and_rays
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    ref = tsl.traverse_closest_slotlane(
        jax_bvh[4], jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(a),
        interpret=True, S=16, k_slots=8,
    )
    got = plain.traverse_closest(port_bvh[4], *_torch(o, d, tmin, a))
    _assert_closest_close(ref, got, R)


def test_stack_overflow_surfaces(scene_and_rays):
    """A stack too small for the tree: closest reports prim -2 with t = T_MAX
    on the overflowing lanes, any hit reports them occluded, and no lane
    that did not overflow changes."""
    jax_bvh, port_bvh, (o, d, a) = scene_and_rays
    small = port_bvh[4]._replace(max_depth=1)
    R = o.shape[0]
    tmin = np.full((R,), 1e-4, np.float32)
    t, p, _, _ = plain.traverse_closest(small, *_torch(o, d, tmin, a))
    tf, pf, _, _ = plain.traverse_closest(port_bvh[4], *_torch(o, d, tmin, a))
    ovf = p == -2
    assert ovf.any()
    assert (t[ovf] == 1e20).all()
    assert torch.equal(p[~ovf], pf[~ovf])
    tmax = torch.full((R,), 30.0)
    occ = plain.traverse_any(small, *_torch(o, d, tmin), tmax, torch.tensor(a))
    assert occ[ovf].all()


def test_sort_permutation_matches_jax(scene_and_rays):
    _, _, (o, d, a) = scene_and_rays
    rng = np.random.default_rng(3)
    o2 = (o + rng.normal(size=o.shape).astype(np.float32) * 3).astype(np.float32)
    ref = np.asarray(jax_sort_perm(jnp.asarray(o2), jnp.asarray(d), jnp.asarray(a)))
    got = plain.ray_sort_perm_only(*_torch(o2, d, a)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_moller_trumbore_matches_jax():
    """Broadcast ray/triangle pairs, a fifth of them aimed at a vertex or
    an edge, where the barycentric band decides. t, u and v are compared
    where the determinant is not small (|det| >= 0.1): below that, 1/det
    magnifies the fused-multiply-add rounding past any fixed tolerance."""
    rng = np.random.default_rng(12)
    n = 4096
    v0, e1, e2 = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    w[: n // 5, 0] = 0.0
    target = v0 + w[:, 1:2] * e1 + w[:, 2:3] * e2
    orig = (target + rng.normal(size=(n, 3)) * 3).astype(np.float32)
    d = (target - orig).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jh, jt, ju, jv = jint.moller_trumbore(*(jnp.asarray(x) for x in (orig, d, v0, e1, e2)), 1e-4)
    th, tt, tu, tv = tint.moller_trumbore(*_torch(orig, d, v0, e1, e2), 1e-4)
    assert (th.numpy() != np.asarray(jh)).sum() <= 2
    both = th.numpy() & np.asarray(jh)
    assert both.mean() > 0.7
    det = np.einsum("ij,ij->i", e1, np.cross(d, e2))
    both &= np.abs(det) >= 0.1
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(jt)[both], rtol=T_RTOL)
    np.testing.assert_allclose(tu.numpy()[both], np.asarray(ju)[both], atol=UV_ATOL)
    np.testing.assert_allclose(tv.numpy()[both], np.asarray(jv)[both], atol=UV_ATOL)
