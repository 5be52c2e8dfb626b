"""The fourteen traversal kernels' wrappers (ops/traverse_cuda.py), one
case a kernel of traverse_cuda.KERNELS, on the CPU.

- Each sizes the kernel's stack at the table's certified bound plus one,
  as the TPU kernels size theirs (a bound of 48 gives 49, where the plain
  flat walk keeps the oracle's 48), and raises at a bound of MAX_STACK
  before it would reach a kernel or the plain walk.
- Each refuses, before any traversal, what its kernel does not take:
  float64 rays, a wrong t_max shape, non-contiguous directions, node rows
  of 24 floats, inputs on two devices, a stack need above MAX_STACK and a
  table of the other kind; the two-level kernels also leaf rows too narrow
  for an instance-entry row, the grid-packet kernels (binary rows only)
  also BVH4 and BVH8 rows.
- On CPU tensors each runs its plain walk (ops/traverse.py) and counts no
  launch.
"""

import numpy as np
import pytest
import torch

from chameleonrt_tpu_torch import _build, native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

FLAT = "proc://city?n=8"
TWO_LEVEL = "proc://instances?nx=2&ny=2&subdiv=0"
KEYS = sorted(traverse_cuda.KERNELS)
FAULTS = ("dtype", "shape", "contiguity", "width", "device_mix", "depth", "table_kind")


def _faults(k):
    extra = ("entry_row",) if k.two_level else ("bvh4", "bvh8") if k.widths == (16,) else ()
    return FAULTS + extra


@pytest.fixture(scope="module")
def pairs():
    """{two-level?: the scene's table pair}: the small city's BlasPair and
    the 2x2 instance grid's UnifiedPair."""
    out = {}
    for two_level, uri in ((False, FLAT), (True, TWO_LEVEL)):
        flat, meta = tds.build_device_scene(load_scene(uri), torch.device("cpu"))
        out[two_level] = ttb.build_blas_set(flat, meta)[0]
    return out


def _table(pairs, key, two_level=None):
    """The table kernel key traces: the binary one for the grid-packet
    kernels, else the wide one; two_level picks the pair (default: the
    kernel's own kind)."""
    k = traverse_cuda.KERNELS[key]
    pair = pairs[k.two_level if two_level is None else two_level]
    return pair.closest if k.widths == (16,) else pair.any


def _rays(table, R, seed):
    """R rays from inside the table's root box (a two-level table's TLAS
    root) in random directions."""
    rng = np.random.default_rng(seed)
    a = table.arity
    row = table.nodes[getattr(table, "tlas_lo", 0)].numpy()
    lo = np.min([row[6 * c : 6 * c + 3] for c in range(a) if row[6 * c] < 1e29], axis=0)
    hi = np.max([row[6 * c + 3 : 6 * c + 6] for c in range(a) if row[6 * c] < 1e29], axis=0)
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _call(key, table, o, d, t_max=None, flag=None):
    R = o.shape[0]
    tmin = torch.full((R,), 1e-4)
    tmax = torch.full((R,), 1e20) if t_max is None else t_max
    flag = torch.ones((R,), dtype=torch.bool) if flag is None else flag
    fn = getattr(traverse_cuda, f"traverse_{key}")
    if traverse_cuda.KERNELS[key].hit == "closest":
        return fn(table, o, d, tmin, flag, tmax)
    return fn(table, o, d, tmin, tmax, flag)


def _no_traversal(monkeypatch):
    def no_traversal(*args, **kwargs):
        raise AssertionError("traversed what the kernels cannot take")

    for fn in ("traverse_closest", "traverse_any", "traverse_closest_unified", "traverse_any_unified"):
        monkeypatch.setattr(plain, fn, no_traversal)
    monkeypatch.setattr(_build, "kernels", no_traversal)


def _with_bound(table, bound):
    if isinstance(table, tds.UnifiedBvh):
        return table._replace(stack_bound=bound)
    return table._replace(max_depth=bound)


@pytest.mark.parametrize("key", KEYS)
def test_wrappers_pass_the_certified_stack_depth(pairs, key, monkeypatch):
    """A certified bound of 48 (the soup's stack4) gives the kernel a stack
    of 49, where the plain versions keep the oracle's 48 (flat; the
    two-level cap is 96); a bound of MAX_STACK needs MAX_STACK + 1 entries
    and raises before any traversal."""
    table = _with_bound(_table(pairs, key), 48)
    seen = []
    real = traverse_cuda.stack_depth
    monkeypatch.setattr(traverse_cuda, "stack_depth", lambda t: seen.append(real(t)) or seen[-1])
    o, d = _rays(table, 64, seed=1)
    _call(key, table, o, d)
    assert seen == [49]
    if traverse_cuda.KERNELS[key].two_level:
        assert plain.unified_stack_limit(table) == 49
    else:
        assert plain.stack_limit(table) == 48
    deep = _with_bound(table, _build.MAX_STACK)
    assert real(deep) == _build.MAX_STACK + 1
    _no_traversal(monkeypatch)
    with pytest.raises(ValueError, match="stack depth"):
        _call(key, deep, o, d)


@pytest.mark.parametrize("key, fault", [(key, f) for key in KEYS
                                        for f in _faults(traverse_cuda.KERNELS[key])])
def test_wrappers_refuse_what_the_kernels_do_not_take(pairs, key, fault, monkeypatch):
    k = traverse_cuda.KERNELS[key]
    table = _table(pairs, key)
    R = 8
    o, d = _rays(table, R, seed=5)
    t_max = None
    if fault == "dtype":
        o = o.double()
    elif fault == "shape":
        t_max = torch.full((R + 1,), 1e20)
    elif fault == "contiguity":
        d = torch.from_numpy(np.asfortranarray(d.numpy()))
        assert not d.is_contiguous()
    elif fault == "width":  # arity 3: the kernels take 2, 4 and 8
        table = table._replace(nodes=torch.zeros((table.nodes.shape[0], 24)))
    elif fault == "device_mix":
        t_max = torch.full((R,), 1e20, device="meta")
    elif fault == "depth":
        table = _with_bound(table, _build.MAX_STACK + 5)
    elif fault == "table_kind":
        table = _table(pairs, key, two_level=not k.two_level)
    elif fault == "entry_row":
        table = table._replace(leaf_rows=table.leaf_rows[:, :10].contiguous())
    elif fault == "bvh4":
        table = pairs[False].any
    else:
        table = table._replace(nodes=torch.zeros((4, 64)))
    _no_traversal(monkeypatch)
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        _call(key, table, o, d, t_max)


@pytest.mark.parametrize("key", KEYS)
def test_wrappers_route_cpu_tensors_to_plain_without_counting(pairs, key):
    k = traverse_cuda.KERNELS[key]
    table = _table(pairs, key)
    R = 200
    o, d = _rays(table, R, seed=7)
    tmin, tmax = torch.full((R,), 1e-4), torch.full((R,), 30.0)
    flag = torch.rand((R,), generator=torch.Generator().manual_seed(7)) > 0.2
    before = dict(traverse_cuda.LAUNCHES)
    got = _call(key, table, o, d, tmax, flag)
    if k.hit == "closest":
        ref = (plain.traverse_closest_unified if k.two_level else plain.traverse_closest)(
            table, o, d, tmin, flag, tmax)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
        assert (ref[1] >= 0).sum() > 0
    else:
        ref = (plain.traverse_any_unified if k.two_level else plain.traverse_any)(
            table, o, d, tmin, tmax, flag)
        assert torch.equal(got, ref) and ref.sum() > 0
    assert traverse_cuda.LAUNCHES == before

