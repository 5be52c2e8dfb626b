"""The port's grid-packet kernels B7a/B7b (ops/traverse_cuda.py
traverse_closest_packet / traverse_any_packet) and their route
(traversal "packet") against the JAX package.

- The wrappers, which run the plain flat traversal on CPU tensors, against
  the JAX traverse_closest_packet / traverse_any_packet that they replace,
  in interpret mode (the suite's K=8 slots, conftest), on
  tests/test_traverse_packet.py's case: 3000 random triangles, 4096 sorted
  rays with 100 inactive, the same binary table (the JAX package's native
  binding over the port's library, test_torch_host).
- The route: make_trace_fns(traversal "packet") traces both hit kinds of
  a flat scene on its binary table through B7a/B7b, whatever
  CHAMELEONRT_SLOTLANE and CHAMELEONRT_CLOSEST_ARITY say, and refuses a
  multi-instance scene; a "packet" frame of the textured hall against the
  JAX `tpu` backend under CHAMELEONRT_CLOSEST_ARITY=2.

Tolerances are those of tests/test_torch_traverse.py (XLA on the CPU fuses
multiply-adds, the port does not): t within rtol 1e-5, u/v within 2e-5;
prims and occlusion flags equal.

The JAX kernels walk a packet of rays with one stack and test every leaf
the packet visits with every live lane; on the card B7a and B7b walk one
ray a lane in the plain walk's order, bit-equal to it (chip_smoke.py holds
them so there, tests/test_torch_walk_host.py holds their walks on the
host), so their plain version is the wrappers' CPU route here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu import native as jnative
from chameleonrt_tpu.ops import traverse_packet as tp
from chameleonrt_tpu.ops.lbvh import PackedBvh as JaxPackedBvh
from chameleonrt_tpu.ops.traverse import ray_sort_perm
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
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
HALL = "proc://hall?subdiv=1&textured=1&columns=4"
CITY = "proc://city?n=8"
INSTANCES = "proc://instances?nx=3&ny=3&subdiv=1"


@pytest.fixture(scope="module")
def soup():
    """(port binary table, JAX binary table, sorted rays) of
    tests/test_traverse_packet.py's clustered soup."""
    rng = np.random.default_rng(0)
    n_tri, n_rays = 3000, 4096
    centers = rng.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    v0 = centers + rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    with jax_native_on_port_library():
        nodes2, _, leaf_rows, depth2, _ = jnative.build_bvh_pair_native(v0, e1, e2, 4)
    table = tds.PackedBvh(torch.from_numpy(nodes2.copy()), torch.from_numpy(leaf_rows.copy()), depth2)
    jtable = JaxPackedBvh(jnp.asarray(nodes2), jnp.asarray(leaf_rows), max_depth=depth2)
    o = jnp.asarray(rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    a = jnp.ones((n_rays,), bool).at[:100].set(False)
    perm, _ = ray_sort_perm(o, d, a)
    return table, jtable, (np.asarray(o[perm]), np.asarray(d[perm]), np.asarray(a[perm]))


@pytest.fixture(scope="module")
def jax_closest(soup):
    """The JAX B7a's (t, prim, u, v) on the soup, in interpret mode."""
    _, jtable, (o, d, a) = soup
    t_min = jnp.full((o.shape[0],), 1e-4, jnp.float32)
    return tuple(np.asarray(x) for x in tp.traverse_closest_packet(
        jtable, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(a), interpret=True))


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def test_closest_packet_matches_jax_packet_kernel(soup, jax_closest):
    table, _, (o, d, a) = soup
    R = o.shape[0]
    t_ref, p_ref, u_ref, v_ref = jax_closest
    before = dict(traverse_cuda.LAUNCHES)
    t, p, u, v = (x.numpy() for x in traverse_cuda.traverse_closest_packet(
        table, *_torch(o, d, np.full(R, 1e-4, np.float32), a, np.full(R, 1e20, np.float32))))
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_allclose(t, t_ref, rtol=T_RTOL)
    np.testing.assert_allclose(u, u_ref, atol=UV_ATOL)
    np.testing.assert_allclose(v, v_ref, atol=UV_ATOL)
    assert (p >= 0).sum() > 0 and (p[~a] == -1).all() and (t[~a] == 1e20).all()
    assert traverse_cuda.LAUNCHES == before


def test_any_packet_matches_jax_packet_kernel(soup, jax_closest):
    """Occlusion at t_max = 1.001 x the closest hit (30 on a miss), with
    the 100 inactive lanes masked out."""
    table, jtable, (o, d, a) = soup
    R = o.shape[0]
    t_ref = jax_closest[0]
    t_min = np.full(R, 1e-4, np.float32)
    t_max = np.where(t_ref < 1e19, t_ref * 1.001, 30.0).astype(np.float32)
    ref = np.asarray(tp.traverse_any_packet(jtable, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                                            jnp.asarray(t_max), jnp.asarray(a), interpret=True))
    got = traverse_cuda.traverse_any_packet(table, *_torch(o, d, t_min, t_max, a)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0 and not got[~a].any()


@pytest.fixture(scope="module")
def city():
    scene = load_scene(CITY)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


@pytest.fixture(scope="module")
def instances():
    scene = load_scene(INSTANCES)
    flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
    return scene, flat._replace(blas=ttb.build_blas_set(flat, meta)), meta


@pytest.mark.parametrize("env", [
    {},
    {"CHAMELEONRT_SLOTLANE": "1"},
    {"CHAMELEONRT_SLOTLANE": "0", "CHAMELEONRT_CLOSEST_ARITY": "4"},
    {"CHAMELEONRT_CLOSEST_ARITY": "2"},
])
def test_grid_packet_routes_both_hit_kinds_through_b7_on_the_binary_table(city, env, monkeypatch):
    """Traversal "packet": closest and any hit of a flat scene both trace
    its binary table (16 floats a row) through B7a and B7b, whatever
    CHAMELEONRT_SLOTLANE and CHAMELEONRT_CLOSEST_ARITY say."""
    _, flat, meta = city
    for k in ("CHAMELEONRT_SLOTLANE", "CHAMELEONRT_CLOSEST_ARITY", "CHAMELEONRT_PACKET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = spy_launches(monkeypatch, tables=True)
    closest, any_ = ttb.make_trace_fns(meta, "packet", blas=flat.blas)
    g = torch.Generator().manual_seed(3)
    o = torch.rand((64, 3), generator=g) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=1)
    active = torch.ones((64,), dtype=torch.bool)
    hit = closest(flat, o, d, 1e-4, active)
    any_(flat, o, d, torch.where(hit.tri >= 0, hit.t, torch.full_like(hit.t, 30.0)), active)
    assert calls == [("closest_packet", 16), ("any_packet", 16)]


def test_grid_packet_refuses_a_multi_instance_scene(instances):
    """The JAX package has no two-level grid-packet kernel: make_trace_fns
    and the backend's set_scene raise ValueError, with the kernels off
    (CHAMELEONRT_PACKET=0) too."""
    scene, flat, meta = instances
    with pytest.raises(ValueError, match="packet traversal"):
        ttb.make_trace_fns(meta, "packet", blas=flat.blas)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("CHAMELEONRT_PACKET", "0")
        with pytest.raises(ValueError, match="packet traversal"):
            ttb.make_trace_fns(meta, "packet")
    b = get_backend("cuda", device="cpu", traversal="packet")
    b.initialize(8, 8)
    with pytest.raises(ValueError, match="packet traversal"):
        b.set_scene(scene)


def test_grid_packet_frame_matches_jax_tpu_backend(tmp_path, monkeypatch):
    """A "packet" frame of the textured hall on the CPU (both hit kinds on
    the binary table) against the JAX tpu backend with closest hit on the
    binary table (CHAMELEONRT_CLOSEST_ARITY=2), the JAX engine's table for
    B7a."""
    monkeypatch.setenv("CHAMELEONRT_CLOSEST_ARITY", "2")
    img_ref, acc_ref, _ = render_frames("tpu", HALL, 40, 1, tmpdir=str(tmp_path))
    launches = spy_launches(monkeypatch)
    b = _render_port(HALL, 40, 1, traversal="packet")
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, b.img[..., :3].astype(np.float32), acc_ref, acc)
    assert launches.count("closest_packet") == 5
