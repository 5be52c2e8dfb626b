"""S1's per-lane body, built for the host and held against the plain
shading on the CPU.

csrc/shade_common.cuh holds shade_lane, the body that S1 (csrc/shade.cu)
runs for each live lane. Here g++ compiles that header against a small shim
of cuda_runtime.h (the CUDA qualifiers and float4; written into the
test's temporary directory) with -ffp-contract=off, the counterpart of
nvcc's -fmad=false, into a harness that runs shade_lane over every lane,
loaded through ctypes with S1's own arguments (ops/shade_cuda.py's
launch_args without the stream: its Scene and Lanes, mirrors of the
header's structs, by reference).

The lanes are those the port shades on the CPU while it renders a frame:
every bounce's live lanes, captured at ops/shade_cuda.shade_bounce, so
bounce 0 and bounce 4 (whose roulette draw is taken) are both there, in
tests/shade_scenes.py's scenes: the Cornell Box, with anisotropic metal,
clearcoat, sheen and a rough dielectric hit from both sides, with rotated
instances inside it, and with three lights, and the textured hall.

Two comparisons with ops/shade_cuda.py's _shade_bounce:
  - exact: the harness's sinf, cosf, logf and powf, and the plain
    version's torch.sqrt, sin, cos, log and pow, are the correctly rounded
    ones (computed in double, rounded once), so that both sides round
    alike. Every field must then be bit-equal on every lane. torch's CPU
    kernels take their own vectorized functions, which are not always
    correctly rounded (torch.sqrt(0.8594591) gives 0.92707014, an ulp
    below), and glibc's may differ from them by an ulp. On the card both
    sides call CUDA's own (tests/test_torch_shade_cuda.py).
  - with torch's own functions: the RNG state equal on every lane, the
    masks (shoot1, shoot2, new_active) on at least 99.99% of lanes, and
    every float field within 1e-5, relative or absolute, on the lanes
    whose masks agree and which read it; the tolerance is there for those
    ulps. The rough dielectric is left out of this one: at its sharp lobes
    float32 turns an ulp of cosf into 0.4% of c2 and 0.17% of
    new_throughput (float64 lies between the two sides), which only the
    exact comparison can hold.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shade_scenes import SCENES, frame_lanes

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.ops import rng, shade_cuda

torch.set_num_threads(1)

W, H = 40, 40
MASKS = ("shoot1", "shoot2", "new_active")
# ShadeOut's float fields and the mask under which _bounce reads each
READ = {"c1": "shoot1", "light_dir": "shoot1", "light_dist": "shoot1", "c2": "shoot2",
        "w_i2": "shoot2", "t_light": "shoot2", "new_throughput": "new_active",
        "cont_dir": "new_active"}

# what shade_common.cuh takes from the CUDA runtime, for the host
SHIM = r"""
#pragma once
#include <string.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
"""

# sinf, cosf, logf and powf correctly rounded: in double, then rounded once
ROUNDED = r"""
#include <math.h>
#define sinf(x) static_cast<float>(sin(static_cast<double>(x)))
#define cosf(x) static_cast<float>(cos(static_cast<double>(x)))
#define logf(x) static_cast<float>(log(static_cast<double>(x)))
#define powf(x, y) static_cast<float>(pow(static_cast<double>(x), static_cast<double>(y)))
"""

# S1's kernel (csrc/shade.cu) as a loop over the lanes of its per-lane body,
# and where each field of Scene and Lanes lies, to hold shade_cuda's mirror to
# the header
HARNESS = r"""
#include <cstddef>
#include "shade_common.cuh"

extern "C" int shade_all(const crt::shade::Scene* s, const crt::shade::Lanes* l, int R,
                         int bounce) {
  for (int i = 0; i < R; ++i) crt::shade::shade_lane(*s, *l, bounce, i);
  return 0;
}
"""


def _layout(struct):
    """C++ that writes the size of struct (a mirror in ops/shade_cuda.py)
    and its fields' offsets, as the header lays them out."""
    name = struct.__name__
    offsets = ", ".join(f"offsetof(crt::shade::{name}, {f})" for f, _ in struct._fields_)
    return (f'extern "C" void layout_{name}(long* out) {{\n'
            f"  const long v[] = {{sizeof(crt::shade::{name}), {offsets}}};\n"
            f"  for (unsigned k = 0; k < sizeof(v) / sizeof(v[0]); ++k) out[k] = v[k];\n}}\n")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness, compiled once per module and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("shade_host")
    (d / "cuda_runtime.h").write_text(SHIM + ROUNDED)
    layouts = _layout(shade_cuda.Scene) + _layout(shade_cuda.Lanes)
    (d / "harness.cpp").write_text(HARNESS + layouts)
    lib = d / "libshade.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{d}", f"-I{_build._CSRC}", "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(str(lib))
    h.shade_all.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    h.shade_all.restype = ctypes.c_int
    return h


_FRAMES = {}


def _frame(name):
    """(name, the shading calls of a W x H frame of scene name), rendered
    once per module."""
    if name not in _FRAMES:
        _FRAMES[name] = frame_lanes(SCENES[name](), W, H)
    return name, _FRAMES[name]


@pytest.fixture(params=sorted(SCENES))
def frame(request):
    return _frame(request.param)


def _run_harness(harness, flat, meta, bounce, lanes):
    outs = shade_cuda.empty_outputs(lanes[0].shape[0], "cpu")
    assert harness.shade_all(*shade_cuda.launch_args(flat, meta, bounce, lanes, outs)) == 0
    return shade_cuda.ShadeOut(*outs)


def _in_double(fn):
    """fn computed in double, rounded once to float32; a Python float
    operand (an exponent) first as its float32, as the kernels take it."""
    def rounded(x, *args):
        args = [a.double() if torch.is_tensor(a) else float(np.float32(a)) for a in args]
        return fn(x.double(), *args).float()
    return rounded


@pytest.fixture
def rounded_plain(monkeypatch):
    """The plain version's sqrt, sin, cos, log and pow correctly rounded."""
    for name in ("sqrt", "sin", "cos", "log", "pow"):
        monkeypatch.setattr(torch, name, _in_double(getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__pow__", _in_double(torch.pow))


@pytest.mark.parametrize("struct", [shade_cuda.Scene, shade_cuda.Lanes],
                         ids=lambda s: s.__name__)
def test_the_struct_mirrors_lay_out_as_the_header(harness, struct):
    """ops/shade_cuda.py's Scene and Lanes, which S1's C entry takes by
    reference, have the header's size and field offsets."""
    n = len(struct._fields_)
    out = (ctypes.c_long * (n + 1))()
    getattr(harness, f"layout_{struct.__name__}")(out)
    want = [ctypes.sizeof(struct)] + [getattr(struct, f).offset for f, _ in struct._fields_]
    assert list(out) == want


def test_the_frames_shade_every_bounce(frame):
    """Each frame shades live lanes at all five bounces, so both the first
    bounce and the roulette's draw (bounces 3 and 4) are held below."""
    name, calls = frame
    assert [c[2] for c in calls] == list(range(5)), name
    assert all(c[3][0].shape[0] > 0 for c in calls), name


@pytest.mark.parametrize("bounce", range(5))
def test_shade_lane_is_bit_equal_to_the_plain_shading(harness, frame, bounce, rounded_plain):
    name, calls = frame
    flat, meta, b, lanes = calls[bounce]
    assert b == bounce
    want = shade_cuda._shade_bounce(flat, meta, bounce, *lanes)
    got = _run_harness(harness, flat, meta, bounce, lanes)
    for field in want._fields:
        a, w = getattr(got, field), getattr(want, field)
        differ = (a != w).reshape(a.shape[0], -1).any(1) & ~(a.isnan() & w.isnan()).reshape(
            a.shape[0], -1).all(1) if a.is_floating_point() else (a != w)
        assert int(differ.sum()) == 0, (name, bounce, field, int(differ.sum()), a.shape[0])


@pytest.mark.parametrize("name", sorted(set(SCENES) - {"materials"}))
def test_shade_lane_agrees_with_torchs_own_functions(harness, name):
    """Against the plain version with torch's own sqrt, sin, cos, log and
    pow, over the frame's five bounces. A float field is compared on the
    lanes whose masks agree and whose mask reads it (READ): elsewhere it is
    never used, and t_light along a direction almost parallel to the
    light's plane, or c2 where the bsdf sample's pdf is near 0, turn an ulp
    into more than 1e-5."""
    _, calls = _frame(name)
    for flat, meta, bounce, lanes in calls:
        want = shade_cuda._shade_bounce(flat, meta, bounce, *lanes)
        got = _run_harness(harness, flat, meta, bounce, lanes)
        assert torch.equal(got.state, want.state), (name, bounce)
        same = torch.ones_like(want.shoot1)
        for field in MASKS:
            same &= getattr(got, field) == getattr(want, field)
        assert int((~same).sum()) <= 1e-4 * same.shape[0], (name, bounce, int((~same).sum()))
        for field, mask in READ.items():
            used = same & getattr(want, mask)
            a, w = getattr(got, field)[used], getattr(want, field)[used]
            err = (a - w).abs() / w.abs().clamp(min=1.0)
            assert not a.numel() or float(err.max()) <= 1e-5, (name, bounce, field, float(err.max()))


def test_the_scenes_reach_every_branch(frame):
    """What the lanes of each scene cover: shadow rays of both MIS
    branches, paths the roulette ends (bounces 3-4), and per scene its own:
    lanes inside the dielectric (w_o below the surface's normal),
    anisotropic, clearcoat and sheen lanes, a textured material, every
    instance, every light picked."""
    name, calls = frame
    shots = [shade_cuda._shade_bounce(flat, meta, b, *lanes) for flat, meta, b, lanes in calls]
    assert sum(int(s.shoot1.sum()) for s in shots) > 0 and sum(int(s.shoot2.sum()) for s in shots) > 0
    # bounces 3 and 4 draw the roulette: the same lanes shaded as bounce 0
    # (no roulette, the same draws before it) lose fewer paths
    kept = sum(int(s.new_active.sum()) for c, s in zip(calls, shots) if c[2] >= 3)
    unculled = sum(int(shade_cuda._shade_bounce(flat, meta, 0, *lanes).new_active.sum())
                   for flat, meta, b, lanes in calls if b >= 3)
    assert kept < unculled
    flat, meta = calls[0][0], calls[0][1]
    if name == "materials":
        tri = torch.cat([c[3][5] for c in calls]).long()
        n_obj = torch.cross(flat.shade_rows[tri, 0:3], flat.shade_rows[tri, 3:6], dim=1)
        dirs = torch.cat([c[3][1] for c in calls])
        mat = flat.shade_rows[tri, 16:30]
        back = (dirs * n_obj).sum(1) > 0
        glass = mat[:, 13] > 0
        assert int((glass & back).sum()) > 20 and int((glass & ~back).sum()) > 20
        assert int((mat[:, 7] > 0).sum()) > 20
        assert int((mat[:, 10] > 0).sum()) > 20 and int((mat[:, 8] > 0).sum()) > 20
    if name == "textured":
        tri = torch.cat([c[3][5] for c in calls]).long()
        handles = flat.shade_rows[tri, 16:30].contiguous().view(torch.int32) < 0
        assert shade_cuda.textured_mask(meta) != 0 and int(handles.any(1).sum()) > 20
    if name == "instances":
        inst = torch.cat([c[3][6] for c in calls])
        assert meta.num_instances == 7 and len(torch.unique(inst)) == 7
    if name == "three_lights":
        _, u_l = rng.lcg_randomf(torch.cat([c[3][0] for c in calls]))
        assert meta.num_lights == 3 and len(torch.unique((u_l * 3).long())) == 3
