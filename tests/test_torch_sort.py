"""The wavefront re-sort's wrapper (ops/sort_cuda.py) and its plain key
(ops/traverse.py's ray_sort_key) on the CPU.

- sort_wavefront checks the seven fields and raises on a wrong dtype, a
  non-contiguous field, a length mismatch, mixed devices and an empty
  wavefront.
- On CPU fields it returns exactly the plain re-sort (ray_sort_perm_only's
  permutation applied to every field) and launches nothing, over seeded
  wavefronts and the edge cases the card tests run: every lane dead, one
  lane, every origin equal, many equal keys.
- ray_sort_key stays below bit 31, so, cast to int32, it sorts stably into
  ray_sort_perm_only's permutation, dead lanes (bit 30) included.
- R2's float32 arithmetic, written out in numpy step by step as
  csrc/sort.cu has it (scale = (1 / d) * 511, as torch computes
  `511.0 / t`), gives ray_sort_key on every lane.
- The ctypes mirror Wave matches crt::sort::Wave in csrc/sort.cu.

The kernels themselves run only on the card: tests/test_torch_sort_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.ops import sort_cuda
from chameleonrt_tpu_torch.ops.traverse import ray_sort_key, ray_sort_perm_only

CSRC = os.path.join(os.path.dirname(sort_cuda.__file__), "..", "csrc", "sort.cu")


def _wave(R, seed, dead=0.3, points=None, octants=None):
    """A seeded wavefront of R lanes in _sort_wavefront's field order.
    points: draw the origins from this many distinct points (ties);
    octants: draw the directions from this many distinct octants; dead:
    the share of dead lanes. Directions carry exact zeros of both signs."""
    rng = np.random.default_rng(seed)
    orig = rng.normal(size=(R, 3)).astype(np.float32) * np.float32(7.5) + np.float32(1.25)
    if points is not None:
        orig = orig[rng.integers(0, points, R) % max(min(points, R), 1)]
    d = rng.normal(size=(R, 3)).astype(np.float32)
    if octants is not None:
        signs = np.array([[1 - 2 * ((o >> k) & 1) for k in (2, 1, 0)] for o in range(8)], np.float32)
        d = np.abs(d) * signs[rng.integers(0, octants, R)]
    d[rng.random((R, 3)) < 0.02] = 0.0
    d[rng.random((R, 3)) < 0.02] = -0.0
    return (
        torch.from_numpy(rng.integers(0, 2**32, R, dtype=np.int64)),
        torch.from_numpy(orig),
        torch.from_numpy(d),
        torch.from_numpy(rng.random((R, 3), dtype=np.float32)),
        torch.from_numpy(rng.random((R, 3), dtype=np.float32)),
        torch.from_numpy(rng.random(R) >= dead),
        torch.from_numpy(rng.permutation(R).astype(np.int64)),
    )


# (name, lanes, _wave's keywords, origins all equal)
CASES = (
    ("seeded", 5000, {}, False),
    ("seeded_mostly_dead", 3001, {"dead": 0.9}, False),
    ("all_dead", 700, {"dead": 1.0}, False),
    ("one_lane", 1, {}, False),
    ("one_dead_lane", 1, {"dead": 1.0}, False),
    ("equal_origins", 900, {}, True),
    ("equal_keys", 4000, {"points": 3, "octants": 2}, False),
)


def _case(name, R, kw, equal, seed):
    wave = list(_wave(R, seed, **kw))
    if equal:
        wave[1] = wave[1][:1].expand(R, 3).contiguous()
    return tuple(wave)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name,R,kw,equal", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [11, 2**31 + 7])
def test_cpu_branch_is_the_plain_resort(name, R, kw, equal, seed):
    wave = _case(name, R, kw, equal, seed)
    perm = ray_sort_perm_only(wave[1], wave[2], wave[5])
    want = tuple(x[perm] for x in wave)
    before = sort_cuda.LAUNCHES
    for got in (sort_cuda.sort_wavefront(*wave), path_tracer._sort_wavefront(*wave),
                sort_cuda.sort_wavefront_plain(*wave)):
        assert len(got) == 7
        for field, g, w in zip(sort_cuda.FIELDS, got, want):
            assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w)), field[0]
    assert sort_cuda.LAUNCHES == before


@pytest.mark.parametrize("name,R,kw,equal", CASES, ids=[c[0] for c in CASES])
def test_int32_key_sorts_into_the_plain_permutation(name, R, kw, equal):
    wave = _case(name, R, kw, equal, 2**31 + 99)
    orig, dir, active = wave[1], wave[2], wave[5]
    key = ray_sort_key(orig, dir, active)
    assert key.dtype == torch.int64
    assert int(key.min()) >= 0 and int(key.max()) < 2**31
    # bit 30 is set exactly on the dead lanes
    assert torch.equal((key >> 30) == 1, ~active)
    perm = torch.sort(key.to(torch.int32), stable=True).indices
    assert torch.equal(perm, ray_sort_perm_only(orig, dir, active))
    if name == "equal_keys":  # stability: ties keep their lane order
        assert int((key[perm][1:] == key[perm][:-1]).sum()) > R // 2


def _expand_bits_10(v):
    v = v & np.uint32(0x3FF)
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
        v = (v | (v << np.uint32(shift))) & np.uint32(mask)
    return v


def _r2_key(orig, dir, active):
    """csrc/sort.cu's R2 in numpy float32, one rounding a step, from the
    bounds of every lane."""
    lo, hi = orig.min(0), orig.max(0)
    d = hi - lo
    d = np.where(d < np.float32(1e-20), np.float32(1e-20), d)
    scale = (np.float32(1.0) / d) * np.float32(511.0)
    v = np.clip((orig - lo) * scale, np.float32(0.0), np.float32(511.0))
    q = v.astype(np.uint32)
    morton = (_expand_bits_10(q[:, 0]) << np.uint32(2)) | (_expand_bits_10(q[:, 1]) << np.uint32(1)) \
        | _expand_bits_10(q[:, 2])
    octant = ((dir[:, 0] < 0) * 4 + (dir[:, 1] < 0) * 2 + (dir[:, 2] < 0)).astype(np.uint32)
    dead = (~active).astype(np.uint32)
    return ((dead << np.uint32(30)) | ((morton >> np.uint32(9)) << np.uint32(12))
            | (octant << np.uint32(9)) | (morton & np.uint32(0x1FF))).astype(np.int32)


@pytest.mark.parametrize("name,R,kw,equal", CASES, ids=[c[0] for c in CASES])
def test_r2_arithmetic_is_the_plain_key(name, R, kw, equal):
    wave = _case(name, R, kw, equal, 5)
    orig, dir, active = wave[1], wave[2], wave[5]
    want = ray_sort_key(orig, dir, active).numpy()
    got = _r2_key(orig.numpy(), dir.numpy(), active.numpy())
    assert np.array_equal(got.astype(np.int64), want)


def test_r2_takes_torchs_reciprocal_then_multiply():
    # torch computes `511.0 / t` as `t.reciprocal() * 511.0`, which rounds
    # twice; a plain division differs from it on some extents
    d = torch.linspace(0.5, 4000.0, 20001, dtype=torch.float32)
    twice = (torch.ones_like(d) / d) * 511.0
    assert torch.equal(511.0 / d, twice)
    assert bool(((511.0 * torch.ones_like(d)).div(d) != twice).any())


def test_wave_mirrors_the_kernels_struct():
    with open(CSRC) as f:
        src = f.read()
    body = re.search(r"struct Wave \{(.*?)\};", src, re.S).group(1)
    members = re.findall(r"(\w+)\*\s+(\w+);", body)
    c_types = {torch.int64: "int64_t", torch.float32: "float", torch.bool: "uint8_t"}
    assert [(t, n) for t, n in members] == [(c_types[dt], n) for n, dt, _ in sort_cuda.FIELDS]
    assert [n for n, _ in sort_cuda.Wave._fields_] == [n for n, _, _ in sort_cuda.FIELDS]


def _bad(case):
    wave = list(_wave(64, 3))
    if case == "dtype_state":
        wave[0] = wave[0].to(torch.int32)
    elif case == "dtype_orig":
        wave[1] = wave[1].double()
    elif case == "dtype_active":
        wave[5] = wave[5].to(torch.uint8)
    elif case == "noncontiguous_dir":
        wave[2] = torch.empty((3, 64)).t()
    elif case == "noncontiguous_lane_pixel":
        wave[6] = torch.arange(128)[::2]
    elif case == "length_illum":
        wave[4] = wave[4][:63]
    elif case == "length_active":
        wave[5] = torch.ones(65, dtype=torch.bool)
    elif case == "shape_throughput":
        wave[3] = wave[3][:, :2].contiguous()
    elif case == "device_orig":
        wave[1] = torch.empty((64, 3), device="meta")
    elif case == "device_state":
        wave[0] = torch.empty((64,), dtype=torch.int64, device="meta")
    elif case == "empty":
        wave = [x[:0] for x in wave]
    return wave


BAD = {"dtype_state": TypeError, "dtype_orig": TypeError, "dtype_active": TypeError,
       "noncontiguous_dir": ValueError, "noncontiguous_lane_pixel": ValueError,
       "length_illum": ValueError, "length_active": ValueError, "shape_throughput": ValueError,
       "device_orig": ValueError, "device_state": ValueError, "empty": ValueError}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_raises_on_what_the_kernels_do_not_take(case):
    before = sort_cuda.LAUNCHES
    with pytest.raises(BAD[case]):
        sort_cuda.sort_wavefront(*_bad(case))
    assert sort_cuda.LAUNCHES == before
