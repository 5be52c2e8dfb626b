"""The walks of the CUDA kernels, built for the host and held bit for bit
against the plain walk, on the CPU.

csrc/traverse_common.cuh holds the walks that B3/B4 (csrc/traverse_unified.cu),
B5c/B5d and B6c/B6d run: closest_two_level and any_two_level over a row
source. Here g++ compiles that header against a small shim of cuda_runtime.h
(written into the test's temporary directory: the CUDA qualifiers, float2,
float4, __ldg, the bit casts, __popc, an __activemask that has a walk
leave its node loop early at every third node row, and counts its calls,
and __shared__ arrays as static ones with a threadIdx that the harness
sets to each ray's index mod 128) with -ffp-contract=off, the counterpart
of nvcc's -fmad=false, into
a harness that runs both walks over GlobalRows for every ray, loaded
through ctypes. The harness must equal ops/traverse.py's
traverse_closest_unified / traverse_any_unified bit for bit: t, prim,
instance, u and v, occlusion, ties included, on the parity grid
(proc://instances?nx=4&ny=4&subdiv=2) at arity 2 (the binary table), 4 and
8 and leaf sizes 4 and 5, on primary rays, on bounce rays from their hit
points and (any hit) on the two masked shadow-ray wavefronts of the first
bounce of a frame that the port renders on the CPU, at both stack
capacities, with the closest walk's node loop taken once per node row and
left early; and on a table whose certified bound is cut so far that the walk
overflows, which gives prim = -2 or occluded, with and without masked-out
lanes.

The same closest walk over a flat table (FlatRows: B1 in
csrc/traverse_flat.cu, B5a in traverse_stream.cu, B6a in
traverse_persistent.cu and B7a in traverse_packet.cu at arity 2), with the
top 8 entries of its stack in shared memory as those kernels keep them
(kShortStack), must equal ops/traverse.py's traverse_closest bit for bit:
t, prim, u and v on the flat parity hall (proc://hall?subdiv=2) at arities
2, 4 and 8 and leaf sizes 4 and 5, on primary rays, bounce rays and
primary rays whose t_max stops half of them short of their hit, at both
stack capacities with the node loop left early; on the 5 closest-hit
wavefronts of a frame of the hall that the port renders on the CPU (later
bounces with inactive lanes); on an overflow (prim = -2, t = 1e20, and the
u, v of the nearest hit the walk found on, as the plain walk keeps them),
with and without inactive lanes; on one-leaf tables, which the walk starts
at leaf 0; and on a table of parallel triangles whose walks push deeper
than the 8 shared entries, so that entries spill to the local array and
come back, with and without an overflow.

The any walk over a flat table (FlatRows: B5b in csrc/traverse_stream.cu,
and B7b in csrc/traverse_packet.cu at arity 2) must equal ops/traverse.py's
traverse_any bit for bit on the flat parity hall at arities 2, 4 and 8 and
leaf sizes 4 and 5: on primary rays at t_max = 1.001 x the closest hit, on
bounce rays at 0.999 x, and on the two masked shadow-ray wavefronts of the
first bounce of a frame of the hall that the port renders on the CPU, at
both stack capacities, its node loop (binary rows only) left early; on a
cut-bound table whose overflow reports the ray
occluded at the push that does not fit, with and without masked-out lanes;
and on one-leaf tables.

This is the walk's logic on the host, not the kernel: chip_smoke.py holds
the kernels themselves to the plain walk on the card.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import camera, rng
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.ops.math import EPSILON
from chameleonrt_tpu_torch.scene.loader import load_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native SAH library unavailable")

PARITY = "proc://instances?nx=4&ny=4&subdiv=2"
FLAT_PARITY = "proc://hall?subdiv=2"
W, H = 64, 40
ARITIES = (2, 4, 8)
LEAVES = (4, 5)
# the top stack entries that the flat closest walk keeps in shared memory
# (kShortStack in csrc/traverse_common.cuh)
FLAT_K = 8
# the ring triangles of _deep_stack's column (the large one behind it is prim DEEP_N)
DEEP_N = 8192
CSRC = traverse_cuda._build._CSRC

# what traverse_common.cuh takes from the CUDA runtime, for the host
SHIM = r"""
#pragma once
#include <stddef.h>
#include <string.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(...)
struct __attribute__((aligned(8))) float2 { float x, y; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float x) { int i; memcpy(&i, &x, 4); return i; }
inline unsigned __float_as_uint(float x) { unsigned u; memcpy(&u, &x, 4); return u; }
inline float __int_as_float(int i) { float x; memcpy(&x, &i, 4); return x; }
// one block's shared arrays: a walk's short stack (WalkStack) is one
// array for the harness, whose rays run one at a time on thread
// threadIdx.x = ray index mod kThreads
#define __shared__ static
struct crt_dim3 { unsigned x, y, z; };
static crt_dim3 threadIdx;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// one lane of a warp alone at every third call, so that a walk's node loop
// is left early (a lane still at a node row) as often as it runs on; the
// harness reports the calls
static unsigned crt_calls;
inline unsigned __activemask() { return ++crt_calls % 3 ? 0xffffffffu : 1u; }
"""

# B3's and B4's kernels (csrc/traverse_unified.cu) as loops over the rays of
# their per-ray bodies, behind their switch onto arity and stack capacity
HARNESS = r"""
#include "traverse_common.cuh"
using namespace crt;

template <int A, int S>
static void closest_all(const float* nodes, const float* leaf_rows, int n_tri, int tlas_lo, int L,
                        int depth, const float* orig, const float* dir, const float* t_min,
                        const float* t_max, const uint8_t* active, float* t_out, int* prim_out,
                        int* inst_out, float* u_out, float* v_out, int R) {
  const GlobalRows<A> t{nodes, leaf_rows, n_tri, tlas_lo, L};
  for (int i = 0; i < R; ++i)
    closest_ray<A, S>(t, depth, orig, dir, t_min, t_max, active, t_out, prim_out, inst_out, u_out,
                      v_out, i);
}

template <int A, int S>
static void any_all(const float* nodes, const float* leaf_rows, int n_tri, int tlas_lo, int L,
                    int depth, const float* orig, const float* dir, const float* t_min,
                    const float* t_max, const uint8_t* mask, uint8_t* occluded, int R) {
  const GlobalRows<A> t{nodes, leaf_rows, n_tri, tlas_lo, L};
  for (int i = 0; i < R; ++i) any_ray<A, S>(t, depth, orig, dir, t_min, t_max, mask, occluded, i);
}

// B1's, B5a's, B6a's and B7a's kernels (csrc/traverse_flat.cu,
// traverse_stream.cu, traverse_persistent.cu, traverse_packet.cu): the same
// closest walk over a flat table, its top kShortStack stack entries in
// shared memory
template <int A, int S>
static void flat_closest_all(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                             int depth, const float* orig, const float* dir, const float* t_min,
                             const float* t_max, const uint8_t* active, float* t_out,
                             int* prim_out, float* u_out, float* v_out, int R) {
  const FlatRows<A> t{{nodes, leaf_rows, n_leaves, 0, L}};
  for (int i = 0; i < R; ++i) {
    threadIdx.x = static_cast<unsigned>(i % kThreads);
    closest_ray<A, S>(t, depth, orig, dir, t_min, t_max, active, t_out, prim_out, nullptr, u_out,
                      v_out, i);
  }
}

// B2's, B5b's, B6b's and B7b's kernels: the same any walk over a flat table
template <int A, int S>
static void flat_any_all(const float* nodes, const float* leaf_rows, int n_leaves, int L,
                         int depth, const float* orig, const float* dir, const float* t_min,
                         const float* t_max, const uint8_t* mask, uint8_t* occluded, int R) {
  const FlatRows<A> t{{nodes, leaf_rows, n_leaves, 0, L}};
  for (int i = 0; i < R; ++i) any_ray<A, S>(t, depth, orig, dir, t_min, t_max, mask, occluded, i);
}

extern "C" {

unsigned activemask_calls() { return crt_calls; }

int walk_flat_any(const float* nodes, const float* leaf_rows, int n_leaves, int arity, int L,
                  int depth, int cap, const float* orig, const float* dir, const float* t_min,
                  const float* t_max, const uint8_t* mask, uint8_t* occluded, int R) {
  CRT_BY_ARITY_STACK(arity, cap, depth, flat_any_all<A, S>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

int walk_flat_closest(const float* nodes, const float* leaf_rows, int n_leaves, int arity, int L,
                      int depth, int cap, const float* orig, const float* dir, const float* t_min,
                      const float* t_max, const uint8_t* active, float* t_out, int* prim_out,
                      float* u_out, float* v_out, int R) {
  CRT_BY_ARITY_STACK(arity, cap, depth, flat_closest_all<A, S>(
      nodes, leaf_rows, n_leaves, L, depth, orig, dir, t_min, t_max, active, t_out, prim_out,
      u_out, v_out, R));
}

int short_stack() { return kShortStack; }

int walk_closest(const float* nodes, const float* leaf_rows, int n_tri, int tlas_lo, int arity,
                 int L, int depth, int cap, const float* orig, const float* dir,
                 const float* t_min, const float* t_max, const uint8_t* active, float* t_out,
                 int* prim_out, int* inst_out, float* u_out, float* v_out, int R) {
  CRT_BY_ARITY_STACK(arity, cap, depth, closest_all<A, S>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, active, t_out,
      prim_out, inst_out, u_out, v_out, R));
}

int walk_any(const float* nodes, const float* leaf_rows, int n_tri, int tlas_lo, int arity, int L,
             int depth, int cap, const float* orig, const float* dir, const float* t_min,
             const float* t_max, const uint8_t* mask, uint8_t* occluded, int R) {
  CRT_BY_ARITY_STACK(arity, cap, depth, any_all<A, S>(
      nodes, leaf_rows, n_tri, tlas_lo, L, depth, orig, dir, t_min, t_max, mask, occluded, R));
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    """The harness, compiled once per module and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("walk_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libwalk.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{d}", f"-I{CSRC}", "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    walks = ctypes.CDLL(str(lib))
    walks.activemask_calls.restype = ctypes.c_uint
    assert walks.short_stack() == FLAT_K
    return walks


@pytest.fixture(scope="module")
def scene():
    return load_scene(PARITY)


@pytest.fixture(scope="module")
def shadow(scene):
    """The two masked shadow-ray wavefronts of the first bounce of one W x H
    frame of the parity grid (_shadow_rays)."""
    return _shadow_rays(scene)


def _shadow_rays(scene, first=2):
    """The first masked shadow-ray wavefronts of one W x H frame of the
    scene (by default the first bounce's two: light samples, then bsdf
    samples toward the lights; first=None: all of them), captured from the
    port's renderer on the CPU as chip_smoke.py captures a main path's:
    [(orig, dir, t_max, mask)]."""
    b = CudaBackend(device="cpu")
    b.initialize(W, H)
    b.set_scene(scene)
    trace_closest, trace_any = b._trace
    calls = []

    def capture(flat, orig, dir, t_max, mask):
        calls.append((orig.clone(), dir.clone(), t_max.clone(), mask.clone()))
        return trace_any(flat, orig, dir, t_max, mask)

    b._trace = (trace_closest, capture)
    cam = scene.cameras[0]
    d = cam.center - cam.position
    b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True,
             readback_framebuffer=False)
    return calls[:first]


def _table(scene, arity, leaf):
    """The parity grid's two-level table of the given arity (2: the binary
    closest-hit table) at leaf size leaf."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("CHAMELEONRT_WIDE_ARITY", "8" if arity == 8 else "4")
        mp.setenv("CHAMELEONRT_LEAF_SIZE", str(leaf))
        flat, meta = tds.build_device_scene(scene, torch.device("cpu"))
        pair = ttb.build_blas_set(flat, meta)[0]
    finally:
        mp.undo()
    table = pair.closest if arity == 2 else pair.any
    assert table.arity == arity and table.leaf_size == leaf
    return flat, table


def _primary(scene):
    """W x H jittered camera rays, all active."""
    cam = scene.cameras[0]
    d = cam.center - cam.position
    view = camera.compute_view_params(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, W, H)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    _, orig, dirs = camera.generate_primary_rays(view, px, py, float(W), float(H),
                                                 rng.get_rng(px + py * W, 1))
    R = orig.shape[0]
    return orig, dirs, torch.zeros((R,)), torch.ones((R,), dtype=torch.bool)


def _bounce(orig, dirs, t, prim, seed=3):
    """Rays from the primary hit points in seeded directions turned back
    against the incoming ray; lanes whose primary ray missed are inactive."""
    hit = prim >= 0
    p = orig + torch.where(hit, t, torch.zeros_like(t))[:, None] * dirs
    w = np.random.default_rng(seed).normal(size=tuple(orig.shape)).astype(np.float32)
    w = torch.nn.functional.normalize(torch.from_numpy(w), dim=1)
    w = torch.where(((w * dirs).sum(1) > 0)[:, None], -w, w)
    return p.contiguous(), w.contiguous(), torch.full((orig.shape[0],), EPSILON), hit


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _table_args(table):
    depth = traverse_cuda.stack_depth(table)
    return ([_ptr(table.nodes), _ptr(table.leaf_rows), table.n_tri_leaves, table.tlas_lo,
             table.arity, table.leaf_size, depth], depth)


def _closest(walks, table, orig, dirs, t_min, active, t_max, cap):
    R = orig.shape[0]
    t, u, v = (torch.empty((R,)) for _ in range(3))
    prim, inst = (torch.empty((R,), dtype=torch.int32) for _ in range(2))
    head, _ = _table_args(table)
    err = walks.walk_closest(*head, cap, *map(_ptr, (orig, dirs, t_min, t_max, active, t, prim,
                                                     inst, u, v)), R)
    assert err == 0
    return t, prim, inst, u, v


def _any(walks, table, orig, dirs, t_min, t_max, mask, cap):
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool)
    head, _ = _table_args(table)
    err = walks.walk_any(*head, cap, *map(_ptr, (orig, dirs, t_min, t_max, mask, occ)), R)
    assert err == 0
    return occ


def _assert_any_bit_equal(walks, table, orig, dirs, t_min, t_max, mask):
    """any_two_level against the plain walk at both stack capacities, on a
    wavefront whose rays take at least 3 node rows. Returns the plain
    flags."""
    count = plain.WalkCount(table)
    want = plain.traverse_any_unified(table, orig, dirs, t_min, t_max, mask, count=count)
    for cap in (64, 128):
        assert torch.equal(_any(walks, table, orig, dirs, t_min, t_max, mask, cap), want)
    assert int(count.visits[0]) >= 3
    return want


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w)


@pytest.mark.parametrize("rays", ["primary", "bounce", "shadow"])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("arity", ARITIES)
def test_walks_equal_the_plain_walk_bit_for_bit(walks, scene, shadow, arity, leaf, rays):
    """closest_two_level and any_two_level over GlobalRows against the
    plain walk on the same table and rays: t, prim, instance, u, v and
    occlusion equal bit for bit (any hit at t_max = 1.001 x the closest
    hit on primary rays, 0.999 x on bounce rays, and on the renderer's own
    masked shadow rays at their t_max), and equal at the 64- and 128-entry
    stack capacities; the closest walk took one __activemask call (its node
    loop's test) per node row of the plain walk, at least 3, so that the
    shim had it leave the node loop early."""
    flat, table = _table(scene, arity, leaf)
    if rays == "shadow":
        for orig, dirs, t_max, mask in shadow:
            assert 0 < int(mask.sum()) < mask.numel()
            _assert_any_bit_equal(walks, table, orig, dirs, torch.full_like(t_max, EPSILON),
                                  t_max, mask)
        return
    orig, dirs, t_min, active = _primary(scene)
    t_max = torch.full((orig.shape[0],), 1e20)
    if rays == "bounce":
        t, prim, _, _, _ = plain.traverse_closest_unified(table, orig, dirs, t_min, active, t_max)
        orig, dirs, t_min, active = _bounce(orig, dirs, t, prim)
    count = plain.WalkCount(table)
    want = plain.traverse_closest_unified(table, orig, dirs, t_min, active, t_max, count=count)
    before = walks.activemask_calls()
    got = _closest(walks, table, orig, dirs, t_min, active, t_max, 64)
    _assert_bit_equal(got, want)
    _assert_bit_equal(_closest(walks, table, orig, dirs, t_min, active, t_max, 128), want)
    calls = (walks.activemask_calls() - before) % 2**32
    node_visits = int(count.visits[0])
    assert calls == 2 * node_visits and node_visits >= 3
    hits = want[1] >= 0
    assert int(hits.sum()) > 50 and int(torch.unique(want[2][hits]).numel()) > 4
    factor = 1.001 if rays == "primary" else 0.999
    t_any = torch.where(want[0] < 1e19, want[0] * factor, torch.full_like(want[0], 100.0))
    a_min = torch.full_like(t_min, EPSILON)
    occ_want = _assert_any_bit_equal(walks, table, orig, dirs, a_min, t_any, active)
    if rays == "primary":  # most hits occlude at 1.001 x their own t
        assert int(occ_want.sum()) > int(hits.sum()) // 2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arity", ARITIES)
def test_overflow_gives_prim_minus_two_and_occluded(walks, scene, arity, masked):
    """A certified bound of 2 makes both walks' stack 3 entries deep: a push
    onto a full stack ends the closest walk with prim = -2 (t = 1e20, no
    instance, u = v = 0) and reports the any walk occluded, as the plain
    walk does, lane for lane; masked: with a seeded half of the lanes
    inactive (closest hit) and masked out (any hit), which stay a miss and
    unoccluded."""
    _, table = _table(scene, arity, 4)
    table = table._replace(stack_bound=2)
    assert traverse_cuda.stack_depth(table) == plain.unified_stack_limit(table) == 3
    orig, dirs, t_min, active = _primary(scene)
    if masked:
        active = torch.from_numpy(np.random.default_rng(5).random(orig.shape[0]) < 0.5)
    t_max = torch.full((orig.shape[0],), 1e20)
    want = plain.traverse_closest_unified(table, orig, dirs, t_min, active, t_max)
    got = _closest(walks, table, orig, dirs, t_min, active, t_max, 64)
    _assert_bit_equal(got, want)
    over = want[1] == -2
    assert int(over.sum()) > 0
    assert bool((want[0][over] == 1e20).all() and (want[2][over] == -1).all())
    occ_want = plain.traverse_any_unified(table, orig, dirs, t_min, t_max, active)
    occ = _any(walks, table, orig, dirs, t_min, t_max, active, 64)
    assert torch.equal(occ, occ_want) and bool(occ[over].all())
    if masked:
        assert not bool(occ[~active].any()) and bool((want[1][~active] == -1).all())


@pytest.fixture(scope="module")
def flat_scene():
    return load_scene(FLAT_PARITY)


def _flat_table(scene, arity, leaf):
    """The flat parity hall's table of the given arity (2: the binary
    closest-hit table, which B7a takes) at leaf size leaf."""
    flat, table = _table(scene, arity, leaf)
    assert isinstance(table, tds.PackedBvh)
    return flat, table


def _flat_closest(walks, table, orig, dirs, t_min, active, t_max, cap):
    R = orig.shape[0]
    t, u, v = (torch.empty((R,)) for _ in range(3))
    prim = torch.empty((R,), dtype=torch.int32)
    depth = traverse_cuda.stack_depth(table)
    err = walks.walk_flat_closest(_ptr(table.nodes), _ptr(table.leaf_rows), table.num_leaves,
                                  table.arity, table.leaf_size, depth, cap,
                                  *map(_ptr, (orig, dirs, t_min, t_max, active, t, prim, u, v)), R)
    assert err == 0
    return t, prim, u, v


@pytest.mark.parametrize("rays", ["primary", "bounce", "capped"])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_walk_equals_the_plain_walk_bit_for_bit(walks, flat_scene, arity, leaf, rays):
    """closest_two_level over FlatRows (B5a's and B7a's walk) against
    plain.traverse_closest on the same flat table and rays: t, prim, u and
    v equal bit for bit at the 64- and 128-entry stack capacities, on
    primary rays, on bounce rays from their hits, and on primary rays whose
    t_max is 0.999 x the hit on every other lane (those lanes then miss);
    the walk took one __activemask call per node row of the plain walk, at
    least 3, so that the shim had it leave the node loop early."""
    _, table = _flat_table(flat_scene, arity, leaf)
    orig, dirs, t_min, active = _primary(flat_scene)
    R = orig.shape[0]
    t_max = torch.full((R,), 1e20)
    if rays != "primary":
        t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active, t_max)
        if rays == "bounce":
            orig, dirs, t_min, active = _bounce(orig, dirs, t, prim)
        else:
            t_max = torch.where((torch.arange(R) % 2 == 0) & (prim >= 0), t * 0.999, t_max)
    count = plain.WalkCount(table)
    want = plain.traverse_closest(table, orig, dirs, t_min, active, t_max, count=count)
    before = walks.activemask_calls()
    _assert_bit_equal(_flat_closest(walks, table, orig, dirs, t_min, active, t_max, 64), want)
    _assert_bit_equal(_flat_closest(walks, table, orig, dirs, t_min, active, t_max, 128), want)
    calls = (walks.activemask_calls() - before) % 2**32
    node_visits = int(count.visits[0])
    assert calls == 2 * node_visits and node_visits >= 3
    hits = want[1] >= 0
    assert int(hits.sum()) > 50
    if rays == "capped":  # the capped lanes stop short of their hit
        assert not bool(hits[::2].any()) and int(hits[1::2].sum()) > 50


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_overflow_gives_prim_minus_two_and_the_plain_walks_uv(walks, flat_scene, arity,
                                                                   masked):
    """A certified depth of 2 makes the flat walk's stack 3 entries deep: a
    push onto a full stack is dropped and the walk goes on, as the plain
    walk's does, and the lane reports prim = -2 and t = 1e20 with the u, v
    of the nearest hit it found, bit for bit as the plain walk; masked: a
    seeded half of the lanes inactive, which stay (1e20, -1, 0, 0)."""
    _, table = _flat_table(flat_scene, arity, 4)
    table = table._replace(max_depth=2)
    assert traverse_cuda.stack_depth(table) == plain.stack_limit(table) == 3
    orig, dirs, t_min, active = _primary(flat_scene)
    if masked:
        active = torch.from_numpy(np.random.default_rng(5).random(orig.shape[0]) < 0.5)
    t_max = torch.full((orig.shape[0],), 1e20)
    want = plain.traverse_closest(table, orig, dirs, t_min, active, t_max)
    _assert_bit_equal(_flat_closest(walks, table, orig, dirs, t_min, active, t_max, 64), want)
    over = want[1] == -2
    assert int(over.sum()) > 0 and bool((want[0][over] == 1e20).all())
    assert bool((want[2][over] != 0).any())  # the u of a hit found after the overflow
    if masked:
        off = ~active
        assert bool((want[1][off] == -1).all() and (want[2][off] == 0).all())


def _one_leaf(flat_scene, arity, leaf):
    """A table of one leaf (three triangles of the scene, the native build's
    leaf row) whose one node row is replaced by empty slots (boxes at 1e30,
    which every ray misses), and 512 seeded rays aimed at the triangles, a
    quarter of them inactive: (table, orig, dirs, t_min, active)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("CHAMELEONRT_LEAF_SIZE", str(leaf))
        mp.setenv("CHAMELEONRT_WIDE_ARITY", "8" if arity == 8 else "4")
        flat, meta = tds.build_device_scene(flat_scene, torch.device("cpu"))
        v0, e1, e2 = ttb.host_triangles(flat)
        nodes2, nodes_w, leaf_rows, depth2, stack_w = ttb._native_build(
            v0[:3], e1[:3], e2[:3], leaf, ttb.wide_arity())
    finally:
        mp.undo()
    nodes = np.full_like(nodes2 if arity == 2 else nodes_w, 1e30)
    table = tds.PackedBvh(torch.as_tensor(nodes), torch.as_tensor(leaf_rows),
                          depth2 if arity == 2 else stack_w)
    assert table.num_leaves == 1 and table.arity == arity and table.leaf_size == leaf
    rng = np.random.default_rng(7)
    R = 512
    centre = (v0[:3] + (e1[:3] + e2[:3]) / 3.0)[rng.integers(0, 3, R)]
    orig = centre + rng.normal(size=(R, 3)) * 2.0
    target = centre + rng.normal(size=(R, 3)) * 0.05
    dirs = target - orig
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    orig, dirs = (torch.from_numpy(x.astype(np.float32)).contiguous() for x in (orig, dirs))
    return table, orig, dirs, torch.zeros((R,)), torch.from_numpy(rng.random(R) < 0.75)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_walk_on_a_one_leaf_table(walks, flat_scene, arity, leaf):
    """A table of one leaf (_one_leaf) starts the walk at leaf 0, never at a
    node row, and the walk equals the plain walk bit for bit on seeded rays
    aimed at the triangles, a quarter of them inactive, with hits."""
    table, orig, dirs, t_min, active = _one_leaf(flat_scene, arity, leaf)
    t_max = torch.full((orig.shape[0],), 1e20)
    want = plain.traverse_closest(table, orig, dirs, t_min, active, t_max)
    _assert_bit_equal(_flat_closest(walks, table, orig, dirs, t_min, active, t_max, 64), want)
    assert 20 < int((want[1] >= 0).sum()) < int(active.sum())


def _deep_stack(arity, n=DEEP_N, rays=256):
    """A table whose walks push deep stacks and must pop every entry: a
    column of n small triangles, one every 0.05 along z, each at a seeded
    angle on a ring of radius 0.9 around the z axis, then one large
    triangle across the axis behind them, built by the native SAH builder at
    the given arity; and seeded rays along +z near the axis. Boxes of a few
    ring triangles contain the axis, so a ray enters most of the column's
    rows nearest first, pushing their other children, and hits nothing
    there: its hit is the large triangle, found only after the walk has
    popped its way back through the stack. (table, orig, dirs, t_min,
    active, t_max)."""
    rng = np.random.default_rng(3)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    v0 = np.stack([0.9 * np.cos(theta) - 0.15, 0.9 * np.sin(theta) - 0.15, np.arange(n) * 0.05], 1)
    e1 = np.tile([[0.3, 0.0, 0.0]], (n, 1))
    e2 = np.tile([[0.0, 0.3, 0.0]], (n, 1))
    v0, e1, e2 = (np.concatenate([x, y]).astype(np.float32) for x, y in (
        (v0, [[-3.0, -3.0, n * 0.05 + 1.0]]), (e1, [[12.0, 0.0, 0.0]]), (e2, [[0.0, 12.0, 0.0]])))
    nodes2, nodes_w, leaf_rows, depth2, stack_w = ttb._native_build(v0, e1, e2, 4,
                                                                    4 if arity == 2 else arity)
    table = tds.PackedBvh(torch.as_tensor(nodes2 if arity == 2 else nodes_w),
                          torch.as_tensor(leaf_rows), depth2 if arity == 2 else stack_w)
    assert table.arity == arity
    orig = np.stack([rng.normal(size=rays) * 0.05, rng.normal(size=rays) * 0.05, -np.ones(rays)], 1)
    dirs = np.stack([rng.normal(size=rays) * 5e-4, rng.normal(size=rays) * 5e-4, np.ones(rays)], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    orig, dirs = (torch.from_numpy(x.astype(np.float32)).contiguous() for x in (orig, dirs))
    return table, orig, dirs, torch.zeros((rays,)), torch.ones((rays,), dtype=torch.bool), \
        torch.full((rays,), 1e20)


def _deepest_push(monkeypatch, walk, table, *args):
    """The plain walk (plain.traverse_closest or traverse_any) on args and
    the deepest stack it pushed (its _push wrapped to record it)."""
    deepest = [0]
    push = plain._push

    def record(stack, sp, limit, code, mask):
        sp, over = push(stack, sp, limit, code, mask)
        if sp.numel():
            deepest[0] = max(deepest[0], int(sp.max()))
        return sp, over

    monkeypatch.setattr(plain, "_push", record)
    want = walk(table, *args)
    monkeypatch.undo()
    return want, deepest[0]


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_walk_short_stack_spills_and_returns(walks, monkeypatch, arity, cut):
    """The flat closest walk, the top FLAT_K entries of its stack in the
    shim's shared array (ring_column), against the plain walk, bit for bit,
    on a table whose walks push deeper than FLAT_K (_deep_stack: the plain
    walk's deepest stack exceeds it), so that entries spill to the local
    array and come back from it, at both stack capacities; cut: the
    certified depth cut to FLAT_K + 1, so that lanes also overflow (prim =
    -2, with the u, v of the hits they find as they walk on) with FLAT_K + 1
    entries on the stack."""
    table, *args = _deep_stack(arity)
    if cut:
        table = table._replace(max_depth=FLAT_K + 1)
    want, deepest = _deepest_push(monkeypatch, plain.traverse_closest, table, *args)
    assert deepest > FLAT_K
    for cap in (64, 128):
        _assert_bit_equal(_flat_closest(walks, table, *args, cap), want)
    over = want[1] == -2
    if cut:  # the walks went on past the overflow and found hits, whose u they keep
        assert int(over.sum()) > 0 and bool((want[2][over] != 0).any())
    else:  # the large triangle, behind the column
        assert not bool(over.any()) and int((want[1] == DEEP_N).sum()) > 200


@pytest.fixture(scope="module")
def flat_frame(flat_scene):
    """The 5 closest-hit wavefronts of one W x H frame of the flat parity
    hall that the port renders on the CPU, captured at B1's launch as the
    backend asks for it (as chip_smoke.py captures a main path's):
    [(orig, dir, t_min, active, t_max)] in call order."""
    calls = []
    real = traverse_cuda.launch_closest

    def capture(key, table, *args):
        assert key == "closest"
        calls.append(tuple(a.clone() for a in args))
        return real(key, table, *args)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(traverse_cuda, "launch_closest", capture)
        b = CudaBackend(device="cpu")
        b.initialize(W, H)
        b.set_scene(flat_scene)
        cam = flat_scene.cameras[0]
        d = cam.center - cam.position
        b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True,
                 readback_framebuffer=False)
    finally:
        mp.undo()
    return calls


@pytest.mark.parametrize("bounce", range(5))
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_walk_on_a_frames_closest_hit_wavefronts(walks, flat_scene, flat_frame, arity, bounce):
    """closest_two_level over FlatRows (B1's, B5a's, B6a's and B7a's walk)
    against plain.traverse_closest on the renderer's own closest-hit
    wavefronts: each of the 5 of one frame (the camera rays, then each
    bounce's, whose lanes are inactive where the path ended) traced on the
    parity hall's table of each arity, t, prim, u and v equal bit for bit
    at the 64- and 128-entry stack capacities."""
    assert len(flat_frame) == 5
    orig, dirs, t_min, active, t_max = flat_frame[bounce]
    if bounce == 0:
        assert bool(active.all())
    else:
        assert 0 < int(active.sum()) < active.numel()
    _, table = _flat_table(flat_scene, arity, 4)
    want = plain.traverse_closest(table, orig, dirs, t_min, active, t_max)
    for cap in (64, 128):
        _assert_bit_equal(_flat_closest(walks, table, orig, dirs, t_min, active, t_max, cap), want)
    assert int((want[1] >= 0).sum()) > 0


@pytest.fixture(scope="module")
def flat_shadow(flat_scene):
    """The two masked shadow-ray wavefronts of the first bounce of one W x H
    frame of the flat parity hall (_shadow_rays)."""
    return _shadow_rays(flat_scene)


def _flat_any(walks, table, orig, dirs, t_min, t_max, mask, cap):
    R = orig.shape[0]
    occ = torch.empty((R,), dtype=torch.bool)
    depth = traverse_cuda.stack_depth(table)
    err = walks.walk_flat_any(_ptr(table.nodes), _ptr(table.leaf_rows), table.num_leaves,
                              table.arity, table.leaf_size, depth, cap,
                              *map(_ptr, (orig, dirs, t_min, t_max, mask, occ)), R)
    assert err == 0
    return occ


def _assert_flat_any_bit_equal(walks, table, orig, dirs, t_min, t_max, mask):
    """any_two_level over FlatRows against plain.traverse_any at both stack
    capacities. Returns the plain flags, the plain walk's node visits and
    the walk's __activemask calls (its binary node loop's test)."""
    count = plain.WalkCount(table)
    want = plain.traverse_any(table, orig, dirs, t_min, t_max, mask, count=count)
    before = walks.activemask_calls()
    for cap in (64, 128):
        assert torch.equal(_flat_any(walks, table, orig, dirs, t_min, t_max, mask, cap), want)
    calls = (walks.activemask_calls() - before) % 2**32
    return want, int(count.visits[0]), calls


@pytest.mark.parametrize("rays", ["primary", "bounce", "shadow"])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_any_walk_equals_the_plain_walk_bit_for_bit(walks, flat_scene, flat_shadow, arity,
                                                         leaf, rays):
    """any_two_level over FlatRows (B5b's and B7b's walk) against
    plain.traverse_any on the same flat table and rays: the occlusion flags
    equal bit for bit at the 64- and 128-entry stack capacities, at t_max =
    1.001 x the closest hit on primary rays (most of them occluded, mostly
    by that very triangle), at 0.999 x on bounce rays from their hits (a
    ray walks every box in front of its hit), and on the renderer's own
    masked shadow rays of the first bounce at their t_max; each wavefront
    takes at least 3 node rows of the plain walk. On binary rows the walk
    took one __activemask call (its node loop's test) per node row of the
    plain walk, so that the shim had it leave the node loop early; at
    arities 4 and 8 none (one loop)."""
    _, table = _flat_table(flat_scene, arity, leaf)

    def node_loop_tests(calls, visits):
        assert visits >= 3 and calls == (2 * visits if arity == 2 else 0)

    if rays == "shadow":
        for orig, dirs, t_max, mask in flat_shadow:
            assert 0 < int(mask.sum()) < mask.numel()
            occ, visits, calls = _assert_flat_any_bit_equal(
                walks, table, orig, dirs, torch.full_like(t_max, EPSILON), t_max, mask)
            node_loop_tests(calls, visits)
            assert not bool(occ[~mask].any())
        return
    orig, dirs, t_min, active = _primary(flat_scene)
    t_inf = torch.full((orig.shape[0],), 1e20)
    t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active, t_inf)
    if rays == "bounce":
        orig, dirs, t_min, active = _bounce(orig, dirs, t, prim)
        t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active, t_inf)
    factor = 1.001 if rays == "primary" else 0.999
    t_any = torch.where(prim >= 0, t * factor, torch.full_like(t, 100.0))
    occ, visits, calls = _assert_flat_any_bit_equal(walks, table, orig, dirs,
                                                    torch.full_like(t_min, EPSILON), t_any, active)
    node_loop_tests(calls, visits)
    hits = int((prim >= 0).sum())
    assert hits > 50
    if rays == "primary":
        assert int(occ.sum()) > hits // 2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_any_overflow_is_occluded_at_the_push(walks, flat_scene, arity, masked):
    """A certified depth of 2 makes the flat any walk's stack 3 entries
    deep: a push onto a full stack reports the ray occluded there, as the
    plain walk does, bit for bit, on primary rays at t_max = 0.999 x their
    closest hit, which without the cut are rarely occluded: so some lanes
    are occluded by the overflow alone; masked: a seeded half of the lanes
    masked out, which stay unoccluded."""
    _, table = _flat_table(flat_scene, arity, 4)
    cut = table._replace(max_depth=2)
    assert traverse_cuda.stack_depth(cut) == plain.stack_limit(cut) == 3
    orig, dirs, t_min, active = _primary(flat_scene)
    t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active,
                                           torch.full((orig.shape[0],), 1e20))
    if masked:
        active = torch.from_numpy(np.random.default_rng(5).random(orig.shape[0]) < 0.5)
    t_any = torch.where(prim >= 0, t * 0.999, torch.full_like(t, 100.0))
    a_min = torch.full_like(t_min, EPSILON)
    occ, _, _ = _assert_flat_any_bit_equal(walks, cut, orig, dirs, a_min, t_any, active)
    uncut = plain.traverse_any(table, orig, dirs, a_min, t_any, active)
    assert int((occ & ~uncut).sum()) > 0
    if masked:
        assert not bool(occ[~active].any())


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_any_walk_on_a_one_leaf_table(walks, flat_scene, arity, leaf):
    """The flat any walk on a table of one leaf (_one_leaf) starts at leaf
    0, never at a node row, and equals the plain walk bit for bit on the
    seeded rays, a quarter of them masked out, at t_max = 1.001 x the
    closest hit on even lanes and 0.999 x on odd ones: occluded where the
    cap lies past the hit, not where it stops short."""
    table, orig, dirs, t_min, active = _one_leaf(flat_scene, arity, leaf)
    R = orig.shape[0]
    t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active,
                                           torch.full((R,), 1e20))
    even = torch.arange(R) % 2 == 0
    t_any = torch.where(prim >= 0, t * torch.where(even, 1.001, 0.999), torch.full_like(t, 100.0))
    occ, _, _ = _assert_flat_any_bit_equal(walks, table, orig, dirs, torch.full_like(t, EPSILON),
                                           t_any, active)
    hit = prim >= 0
    assert int((occ & hit & even).sum()) > 10 and not bool((occ & ~even).any())


@pytest.fixture(scope="module")
def flat_frame_shadow(flat_scene):
    """All masked shadow-ray wavefronts of one W x H frame of the flat
    parity hall (_shadow_rays), as the main path's frame traces them."""
    return _shadow_rays(flat_scene, first=None)


@pytest.mark.parametrize("call", range(10))
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_any_walk_on_a_frames_shadow_wavefronts(walks, flat_scene, flat_frame_shadow, arity,
                                                     call):
    """any_two_level over FlatRows (B2's, B5b's, B6b's and B7b's walk)
    against plain.traverse_any on the renderer's own shadow rays: each of
    the 10 masked wavefronts of one frame (light and bsdf samples of each
    of its 5 bounces, in call order) traced on the parity hall's table of
    each arity at its t_max and mask, the occlusion flags equal bit for bit
    at the 64- and 128-entry stack capacities; masked-out lanes are never
    occluded."""
    assert len(flat_frame_shadow) == 10
    orig, dirs, t_max, mask = flat_frame_shadow[call]
    assert 0 < int(mask.sum()) < mask.numel()
    _, table = _flat_table(flat_scene, arity, 4)
    occ, _, _ = _assert_flat_any_bit_equal(walks, table, orig, dirs,
                                           torch.full_like(t_max, EPSILON), t_max, mask)
    assert not bool(occ[~mask].any())


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("arity", ARITIES)
def test_flat_any_walk_pops_back_through_a_deep_stack(walks, monkeypatch, arity, cut):
    """The flat any walk against the plain walk, bit for bit, on a table
    whose walks push deeper than FLAT_K (_deep_stack: deeper than the
    closest walk keeps in shared memory; the any walk keeps its whole stack
    in its local array) and pop back through every entry before they reach
    the large triangle: t_max is 1.001 x that hit on even lanes (occluded)
    and 0.999 x on odd ones (they walk the whole column and miss), at both
    stack capacities; cut: the certified depth cut to FLAT_K + 1, so that
    the walks overflow at the push that does not fit, which occludes the
    odd lanes too."""
    table, orig, dirs, t_min, active, t_inf = _deep_stack(arity)
    t, prim, _, _ = plain.traverse_closest(table, orig, dirs, t_min, active, t_inf)
    assert bool((prim == DEEP_N).all())
    even = torch.arange(orig.shape[0]) % 2 == 0
    t_max = t * torch.where(even, 1.001, 0.999)
    a_min = torch.full_like(t_min, EPSILON)
    if cut:
        table = table._replace(max_depth=FLAT_K + 1)
    _, deepest = _deepest_push(monkeypatch, plain.traverse_any, table, orig, dirs, a_min, t_max,
                               active)
    assert deepest > FLAT_K
    occ, _, _ = _assert_flat_any_bit_equal(walks, table, orig, dirs, a_min, t_max, active)
    assert bool(occ[even].all())
    if cut:  # occluded by the overflow alone
        assert int(occ[~even].sum()) > 100
    else:
        assert not bool(occ[~even].any())
