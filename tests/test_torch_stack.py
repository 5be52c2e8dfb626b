"""The kernels' stack capacities (C3) and their C entries' arguments, on the CPU.

- Every kernel (B1-B7b, one ray a lane) launches the
  instantiation of the smallest stack capacity that holds the table's
  certified stack + 1 (traverse_cuda.stack_capacity: 64, else 128), at
  every arity; the input check takes stacks up to MAX_STACK = 128 and
  refuses 129.
- Each C entry gets the arguments its binding (traverse_cuda's, from
  KERNELS) declares, in order: the wrappers run against a stand-in for the
  kernels' library on tensors of the meta device, which take the kernel
  path without a card, and the capacity and the launch counts by capacity
  are read off the calls.
- A frame under CHAMELEONRT_WIDE_ARITY=8 of a 4,096-instance grid whose
  BVH8 certified stack + 1 exceeds 64, which the port refused before: the
  `cuda` backend on the CPU against the JAX `tpu` backend, held to
  tests/test_cross_backend.py's _assert_images_match.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch import _build, native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match
from test_torch_switches import _JAX_JOBS, ROOT, _clean_env

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native SAH library unavailable")

FLAT = "proc://cornell"
TWO_LEVEL = "proc://instances?nx=2&ny=2&subdiv=0"
# its BVH8 table at leaves of 2 needs a stack of 67
DEEP = "proc://instances?nx=64&ny=64&subdiv=6"
DEEP_ENV = {"CHAMELEONRT_WIDE_ARITY": "8", "CHAMELEONRT_LEAF_SIZE": "2"}
ARITIES = (2, 4, 8)


def _tables(uri, monkeypatch, wide=4, leaf=4):
    """The scene's (closest, any) tables, built under the given switches."""
    monkeypatch.setenv("CHAMELEONRT_WIDE_ARITY", str(wide))
    monkeypatch.setenv("CHAMELEONRT_LEAF_SIZE", str(leaf))
    flat, meta = tds.build_device_scene(load_scene(uri), torch.device("cpu"))
    pair = ttb.build_blas_set(flat, meta)[0]
    return pair.closest, pair.any


@pytest.fixture(scope="module")
def tables():
    """{(flat or two-level, arity): table} at leaf size 4."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for kind, uri in (("flat", FLAT), ("two_level", TWO_LEVEL)):
            out[kind, 2], out[kind, 4] = _tables(uri, mp)
            out[kind, 8] = _tables(uri, mp, wide=8)[1]
    finally:
        mp.undo()
    return out


def _with_depth(table, depth):
    """The table with a certified bound that makes stack_depth `depth`."""
    if isinstance(table, tds.UnifiedBvh):
        return table._replace(stack_bound=depth - 1)
    return table._replace(max_depth=depth - 1)


def _rays(R, device="cpu"):
    g = torch.Generator().manual_seed(5)
    o = torch.rand((R, 3), generator=g) - 0.5
    d = torch.nn.functional.normalize(torch.randn((R, 3), generator=g), dim=1)
    return o.to(device), d.to(device)


# wrapper: (launch-count key, C entry, closest hit?, table kind)
WRAPPERS = {
    f"traverse_{key}": (key, k.entry, k.hit == "closest",
                        "two_level" if k.two_level else "binary" if k.widths == (16,) else "flat")
    for key, k in traverse_cuda.KERNELS.items()
}


def _table_for(tables, kind, arity=4):
    return tables["flat", 2] if kind == "binary" else tables[kind, arity]


def _call(name, table, R=16, device="cpu"):
    _, _, closest, _ = WRAPPERS[name]
    o, d = _rays(R, device)
    tmin = torch.full((R,), 1e-4, device=device)
    tmax = torch.full((R,), 1e20, device=device)
    flag = torch.ones((R,), dtype=torch.bool, device=device)
    fn = getattr(traverse_cuda, name)
    return fn(table, o, d, tmin, flag, tmax) if closest else fn(table, o, d, tmin, tmax, flag)


@pytest.mark.parametrize("arity", ARITIES)
@pytest.mark.parametrize("depth", [2, 64, 65, 128])
def test_per_lane_kernels_take_the_smallest_capacity_that_holds_the_stack(tables, depth, arity,
                                                                          monkeypatch):
    """B1's and B3's wrappers pick 64 entries for a stack of up to 64 and
    128 above, at every arity, before they dispatch (here to the plain
    walk, on CPU tensors)."""
    want = 64 if depth <= 64 else 128
    assert traverse_cuda.stack_capacity(depth) == want
    seen = []
    real = traverse_cuda.stack_capacity
    monkeypatch.setattr(traverse_cuda, "stack_capacity", lambda n: seen.append(real(n)) or seen[-1])
    for name, kind in (("traverse_closest", "flat"), ("traverse_closest_unified", "two_level")):
        table = _with_depth(tables[kind, arity], depth)
        assert traverse_cuda.stack_depth(table) == depth
        _call(name, table)
    assert seen == [want, want]


@pytest.mark.parametrize("kind", ["flat", "two_level", "binary"])
@pytest.mark.parametrize("depth", [128, 129])
def test_check_takes_stacks_up_to_max_stack(tables, kind, depth):
    """The input check passes a stack of MAX_STACK = 128 entries to the
    kernels and refuses 129, for flat, two-level and grid-packet tables."""
    assert _build.MAX_STACK == 128 and _build.STACK_CAPACITIES == (64, 128)
    table = _with_depth(_table_for(tables, kind), depth)
    key = {"flat": "closest", "two_level": "closest_unified", "binary": "closest_packet"}[kind]
    R = 8
    o, d = _rays(R)
    args = (o, d, torch.zeros((R,)), torch.full((R,), 1e20), torch.ones((R,), dtype=torch.bool))
    if depth > _build.MAX_STACK:
        with pytest.raises(ValueError, match="stack depth 129 exceeds the kernel's 128"):
            traverse_cuda._check(traverse_cuda.KERNELS[key], table, *args)
    else:
        assert traverse_cuda._check(traverse_cuda.KERNELS[key], table, *args)[2] == depth


class _Entry:
    """A C entry of the stand-in library: records its arguments."""

    def __init__(self, name, calls):
        self.name, self.calls, self.argtypes, self.restype = name, calls, None, None

    def __call__(self, *args):
        if self.name == "crt_max_stack":
            return _build.MAX_STACK
        if self.name == "crt_max_leaf":
            return _build.MAX_LEAF
        self.calls.append((self.name, args))
        return 0


class _Library:
    """Stands in for the kernels' library: any entry, bound by
    _build.load_library as the real one is."""

    def __init__(self, path):
        self.calls = []

    def __getattr__(self, name):
        entry = _Entry(name, self.calls)
        setattr(self, name, entry)
        return entry


@pytest.mark.parametrize("depth", [64, 65])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_c_entries_get_the_capacity_and_shared_rows(tables, name, depth, monkeypatch):
    """On a device other than the CPU each wrapper calls its C entry with
    as many arguments as its binding declares: after the depth, the
    kernel's stack capacity (64 at depth 64, 128 at 65). The launch counts
    move by one, under the capacity the launch ran with."""
    key, entry, _, kind = WRAPPERS[name]
    monkeypatch.setattr(_build.ctypes, "CDLL", _Library)
    lib = _build.load_library("stand-in")
    monkeypatch.setattr(_build, "kernels", lambda: lib)
    monkeypatch.setattr(traverse_cuda, "_stream", lambda x: 0)
    table = _with_depth(_table_for(tables, kind), depth)
    meta = table._replace(nodes=table.nodes.to("meta"), leaf_rows=table.leaf_rows.to("meta"))
    launches, stacks = dict(traverse_cuda.LAUNCHES), {k: dict(v) for k, v in
                                                      traverse_cuda.STACK_LAUNCHES.items()}
    _call(name, meta, R=40, device="meta")
    [(called, args)] = lib.calls
    assert called == entry
    assert len(args) == len(getattr(lib, entry).argtypes)
    L = table.leaf_size
    if kind == "two_level":
        head = [table.n_tri_leaves, table.tlas_lo, table.arity, L, depth]
        lead = args[2:7]
    else:
        head = [table.leaf_rows.shape[0]] + ([] if kind == "binary" else [table.arity]) + [L, depth]
        lead = args[2:2 + len(head)]
    assert list(lead) == head
    rest = list(args[2 + len(head):])
    cap = 64 if depth <= 64 else 128
    assert rest[0] == cap and rest[1] == 0  # the capacity, then the rays' pointer
    assert args[-2:] == (40, 0)  # R, the stream
    assert traverse_cuda.LAUNCHES[key] == launches[key] + 1
    assert traverse_cuda.STACK_LAUNCHES[key] == {**stacks[key], cap: stacks[key][cap] + 1}


def test_bvh8_frame_deeper_than_64_stacks_matches_jax_tpu_backend(tmp_path, monkeypatch):
    """C3: under CHAMELEONRT_WIDE_ARITY=8 (leaves of 2) the 4,096-instance
    grid's two-level table needs a stack of 67, which the kernels' check
    refused above 64. Now the wrappers take it at capacity 128, and the
    port's frame (the `cuda` backend on the CPU) matches the JAX `tpu`
    backend's, one 32x32 frame each."""
    job = {"key": ["bvh8"], "env": DEEP_ENV, "uri": DEEP, "res": 32, "spp": 0,
           "out": str(tmp_path / "bvh8.npz")}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_JOBS, json.dumps([job])], cwd=ROOT,
                            env=_clean_env())
    try:
        for k, v in DEEP_ENV.items():
            monkeypatch.setenv(k, v)
        caps = []
        real = traverse_cuda.stack_capacity
        monkeypatch.setattr(traverse_cuda, "stack_capacity", lambda n: caps.append(real(n)) or caps[-1])
        scene = load_scene(DEEP)
        b = get_backend("cuda", device="cpu")
        b.initialize(32, 32)
        b.set_scene(scene)
        assert traverse_cuda.stack_depth(b.flat.blas[0].any) == 67
        cam = scene.cameras[0]
        d = cam.center - cam.position
        b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True)
        assert proc.wait(timeout=900) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert caps and set(caps) == {128}
    acc = b._accum.numpy()
    assert np.isfinite(acc).all() and acc.max() > 0
    with np.load(job["out"]) as z:
        _assert_images_match(z["img"], b.img[..., :3].astype(np.float32), z["accum"], acc)
