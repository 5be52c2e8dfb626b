"""The traversal route (engine/trace_bvh.py choose_route) against the
table in its docstring, on the CPU: every traversal value, on flat
tables, two-level tables and the flat tables of a multi-instance scene
(the LBVH fallback's, traced instance by instance), with no switch set
and under CHAMELEONRT_PACKET=0, CHAMELEONRT_SLOTLANE=0 and
CHAMELEONRT_CLOSEST_ARITY=2, each with an L2 just below and just above
the table's size; "packet" on a multi-instance scene and an unknown
value raise.

It also holds the spies that other files' route tests use: spy_launches
(which kernels trace functions launch) and l2_of (the L2 the gate
weighs).
"""

import pytest
import torch

from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
from chameleonrt_tpu_torch.ops import traverse_cuda

SWITCHES = ("CHAMELEONRT_PACKET", "CHAMELEONRT_SLOTLANE", "CHAMELEONRT_CLOSEST_ARITY")
ENVS = {"none": {}, "packet_0": {"CHAMELEONRT_PACKET": "0"},
        "slotlane_0": {"CHAMELEONRT_SLOTLANE": "0"}, "closest_arity_2": {"CHAMELEONRT_CLOSEST_ARITY": "2"}}
# scene: (instances, two-level tables)
SCENES = {"flat": (1, False), "two_level": (4, True), "lbvh_instanced": (4, False)}
# the docstring's table: the tier of each value; "gate" by the L2, None the plain walk
TIERS = {"auto": "gate", "plain": None, "lane": "", "stream": "_stream",
         "persistent": "_persistent", "packet": "_packet"}


def spy_launches(monkeypatch, tables=False):
    """Record the KERNELS key of every launch that trace functions ask of
    the two launchers (with the traced table's node row width where
    tables is set); the launches still run."""
    calls = []
    for name in ("launch_closest", "launch_any"):
        real = getattr(traverse_cuda, name)

        def spy(key, table, *args, _real=real):
            calls.append((key, table.nodes.shape[1]) if tables else key)
            return _real(key, table, *args)

        monkeypatch.setattr(traverse_cuda, name, spy)
    return calls


def l2_of(monkeypatch, n):
    """Make the streamed tier's gate weigh tables against an L2 of n bytes."""
    real = ttb.streamed_tier
    monkeypatch.setattr(ttb, "streamed_tier", lambda table, l2_bytes=None: real(table, n))


def _expected(traversal, instances, two_level, env, exceeds):
    """The route the docstring's table gives, or the error's message."""
    if traversal not in TIERS:
        return "traversal must be one of"
    if traversal == "packet" and instances > 1:
        return "flat scenes only"
    tier = TIERS[traversal]
    if env.get("CHAMELEONRT_PACKET") == "0":
        tier = None
    elif tier == "gate":
        tier = ("_persistent" if env.get("CHAMELEONRT_SLOTLANE") == "0"
                else "_stream" if exceeds else "")
    packet = traversal == "packet"
    tables = ("closest" if packet or env.get("CHAMELEONRT_CLOSEST_ARITY") == "2" else "any",
              "closest" if packet else "any")
    if tier is None:
        return ("plain", "plain", *tables)
    kind = "_unified" if two_level else ""
    return (f"closest{kind}{tier}", f"any{kind}{tier}", *tables)


@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("traversal", [*ttb.TRAVERSALS, "bvh"])
def test_the_route_follows_its_table(traversal, scene, env, monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    instances, two_level = SCENES[scene]
    if two_level:
        table = UnifiedBvh(torch.zeros((9, 32)), torch.zeros((7, 40)), 3, 6, 5)
    else:
        table = PackedBvh(torch.zeros((9, 32)), torch.zeros((7, 40)), 5)
    size = ttb.table_bytes(table)
    for l2, exceeds in ((size - 1, True), (size, False)):
        want = _expected(traversal, instances, two_level, ENVS[env], exceeds)
        if isinstance(want, str):
            with pytest.raises(ValueError, match=want):
                ttb.choose_route(traversal, instances, two_level, table, l2_bytes=l2)
        else:
            got = ttb.choose_route(traversal, instances, two_level, table, l2_bytes=l2)
            assert got == want, l2
            assert {got.closest, got.any} <= {"plain", *traverse_cuda.KERNELS}
