"""The JAX engine's table switches in the port (engine/trace_bvh.py), and
frames at more than one sample per pixel, against the JAX package.

- The readers: CHAMELEONRT_WIDE_ARITY, CHAMELEONRT_LEAF_SIZE,
  CHAMELEONRT_CLOSEST_ARITY and CHAMELEONRT_PACKET read as
  chameleonrt_tpu/engine/trace_bvh.py reads them, with its error messages.
- Under each switch (closest hit on the binary table, BVH8 rows, leaves of
  8, 2 and 12 triangles, no kernels) a flat and an instanced frame from the
  port's `cuda` backend on the CPU against the JAX `tpu` backend, held to
  tests/test_cross_backend.py's _assert_images_match; a spy on the
  traversal functions shows the row widths each hit kind traced.
- The kernels' input check takes node rows of 16, 32 and 64 floats (arity
  2, 4 and 8) and refuses any other width.
- One 3-spp frame of proc://cornell, image and RenderStats.rays_traced.

The JAX frames render in subprocesses (tests/subproc_render.py says why),
all of them at once at the first test that needs them, a few to a process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh
from chameleonrt_tpu_torch.ops import traverse as plain
from chameleonrt_tpu_torch.ops import traverse_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_cross_backend import _assert_images_match

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT = "proc://cornell"
INSTANCED = "proc://instances?nx=2&ny=2&subdiv=0"
RES = 32
# each switch as a user sets it
SWITCHES = {
    "closest_arity_2": {"CHAMELEONRT_CLOSEST_ARITY": "2"},
    "wide_arity_8": {"CHAMELEONRT_WIDE_ARITY": "8"},
    "leaf_size_8": {"CHAMELEONRT_LEAF_SIZE": "8"},
    "leaf_size_2": {"CHAMELEONRT_LEAF_SIZE": "2"},
    "leaf_size_12": {"CHAMELEONRT_LEAF_SIZE": "12"},
    "packet_0": {"CHAMELEONRT_PACKET": "0"},
}
SPP_URI, SPP_RES, SPP = "proc://cornell", 40, 3
ALL_SWITCHES = ("CHAMELEONRT_CLOSEST_ARITY", "CHAMELEONRT_WIDE_ARITY", "CHAMELEONRT_LEAF_SIZE",
                "CHAMELEONRT_PACKET")

# Renders jobs [{"env", "uri", "res", "spp", "out"}] with the JAX `tpu`
# backend, one frame each, in this process, as tests/subproc_render.py does
# (its view), with each job's environment set around its build and render.
_JAX_JOBS = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from chameleonrt_tpu.core import get_backend
from chameleonrt_tpu.scene.loader import load_scene
for job in json.loads(sys.argv[1]):
    saved = dict(os.environ)
    os.environ.update(job["env"])
    scene = load_scene(job["uri"])
    b = get_backend("tpu")
    b.initialize(job["res"], job["res"])
    b.set_scene(scene)
    if job["spp"]:
        b.samples_per_pixel = job["spp"]
    cam = scene.cameras[0]
    d = cam.center - cam.position
    st = b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True)
    np.savez(job["out"], img=b.img[..., :3].astype(np.float32), accum=np.asarray(b._accum),
             rays=np.int64(st.rays_traced))
    os.environ.clear()
    os.environ.update(saved)
"""
JAX_PROCS = 3


def _clean_env():
    return {k: v for k, v in os.environ.items() if k not in ALL_SWITCHES}


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    """(img, accum, rays) of every JAX frame these tests compare with, by
    (switch, uri): each switch's flat and instanced frame, and the 3-spp
    frame under ("spp", SPP_URI)."""
    tmp = tmp_path_factory.mktemp("jax_frames")
    jobs = []
    for name, env in SWITCHES.items():
        for i, uri in enumerate((FLAT, INSTANCED)):
            jobs.append({"key": [name, uri], "env": env, "uri": uri, "res": RES, "spp": 0,
                         "out": str(tmp / f"{name}_{i}.npz")})
    jobs.append({"key": ["spp", SPP_URI], "env": {}, "uri": SPP_URI, "res": SPP_RES, "spp": SPP,
                 "out": str(tmp / "spp.npz")})
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_JOBS, json.dumps(jobs[k::JAX_PROCS])],
                              cwd=ROOT, env=_clean_env())
             for k in range(JAX_PROCS)]
    try:
        for p in procs:
            assert p.wait(timeout=900) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = {}
    for job in jobs:
        with np.load(job["out"]) as z:
            out[tuple(job["key"])] = (z["img"].copy(), z["accum"].copy(), int(z["rays"]))
    return out


def _spy(monkeypatch):
    """Record each traversal call: (which function, node row width, leaf
    row width), for the kernels' launches (as their wrappers' names) and
    for the plain versions, which the plain route calls directly."""
    calls = []
    for name in ("launch_closest", "launch_any"):
        real = getattr(traverse_cuda, name)

        def launch(key, table, *args, _real=real):
            calls.append(("kernel", f"traverse_{key}", table.nodes.shape[1], table.leaf_rows.shape[1]))
            return _real(key, table, *args)

        monkeypatch.setattr(traverse_cuda, name, launch)
    for name in ("traverse_closest", "traverse_any", "traverse_closest_unified",
                 "traverse_any_unified"):
        real = getattr(plain, name)

        def spy(table, *args, _real=real, _name=name, **kwargs):
            calls.append(("plain", _name, table.nodes.shape[1], table.leaf_rows.shape[1]))
            return _real(table, *args, **kwargs)

        monkeypatch.setattr(plain, name, spy)
    return calls


def _render_port(uri, res, spp=0):
    """One frame of the port's `cuda` backend on the CPU; returns (image,
    accum, RenderStats)."""
    scene = load_scene(uri)
    b = get_backend("cuda", device="cpu")
    b.initialize(res, res)
    b.set_scene(scene)
    if spp:
        b.samples_per_pixel = spp
    cam = scene.cameras[0]
    d = cam.center - cam.position
    st = b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True)
    return b.img[..., :3].astype(np.float32), b._accum.numpy(), st


@pytest.mark.parametrize("uri", [FLAT, INSTANCED])
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_frames_match_jax_tpu_backend(jax_frames, switch, uri, monkeypatch):
    """Under each switch the port's frame matches the JAX frame, and each
    hit kind traced the table the JAX engine traces: closest hit the binary
    table (16 floats a row) under CLOSEST_ARITY=2, else the wide one; any
    hit the wide one (64 floats under WIDE_ARITY=8, else 32); leaf rows of
    10L floats; with PACKET=0 the plain traversal and no kernel wrapper."""
    env = SWITCHES[switch]
    for k in ALL_SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _spy(monkeypatch)
    img, acc, _ = _render_port(uri, RES)
    img_ref, acc_ref, _ = jax_frames[switch, uri]
    assert np.isfinite(acc).all() and acc.max() > 0
    _assert_images_match(img_ref, img, acc_ref, acc)

    wide = 64 if switch == "wide_arity_8" else 32
    closest = 16 if switch == "closest_arity_2" else wide
    leaf = 10 * int(env.get("CHAMELEONRT_LEAF_SIZE", 4))
    kind = "_unified" if uri == INSTANCED else ""
    route = "plain" if switch == "packet_0" else "kernel"
    seen = {(tag, name, n, lf) for tag, name, n, lf in calls if tag == route}
    assert seen == {(route, f"traverse_closest{kind}", closest, leaf),
                    (route, f"traverse_any{kind}", wide, leaf)}
    if route == "plain":
        assert not [c for c in calls if c[0] == "kernel"]


@pytest.mark.parametrize("var, value, port, ref", [
    ("CHAMELEONRT_WIDE_ARITY", "3", ttb.wide_arity, jtb._wide_arity),
    ("CHAMELEONRT_WIDE_ARITY", "eight", ttb.wide_arity, jtb._wide_arity),
    ("CHAMELEONRT_LEAF_SIZE", "13", ttb.native_leaf_size, jtb._native_leaf_size),
    ("CHAMELEONRT_LEAF_SIZE", "1", ttb.native_leaf_size, jtb._native_leaf_size),
    ("CHAMELEONRT_LEAF_SIZE", "x", ttb.native_leaf_size, jtb._native_leaf_size),
])
def test_invalid_switches_raise_the_jax_messages(var, value, port, ref, monkeypatch):
    """Out-of-range and non-integer values raise ValueError with the JAX
    engine's message, from the reader and from a backend's set_scene."""
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        get_backend("cuda", device="cpu").set_scene(load_scene(FLAT))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env, arity, wide, leaf, kernels", [
    ({}, 4, 4, 4, True),
    ({"CHAMELEONRT_CLOSEST_ARITY": "2"}, 2, 4, 4, True),
    ({"CHAMELEONRT_CLOSEST_ARITY": "4", "CHAMELEONRT_WIDE_ARITY": "8"}, 8, 8, 4, True),
    ({"CHAMELEONRT_LEAF_SIZE": "12", "CHAMELEONRT_PACKET": "1"}, 4, 4, 12, True),
    ({"CHAMELEONRT_PACKET": "0"}, 4, 4, 4, False),
    ({"CHAMELEONRT_PACKET": "false"}, 4, 4, 4, False),
    ({"CHAMELEONRT_PACKET": "off"}, 4, 4, 4, False),
])
def test_switches_read_as_the_jax_package(env, arity, wide, leaf, kernels, monkeypatch):
    """The readers give what the JAX engine's give: the table closest hit
    traces (_closest_table), the wide arity, the leaf size and whether the
    kernels run (_packet_enabled, which on this CPU is False unless the
    variable says otherwise)."""
    for k in ALL_SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pair = type("Pair", (), {"closest": 2, "any": "wide"})
    assert ttb.closest_arity() == arity
    assert (jtb._closest_table(pair) == 2) == (arity == 2)
    assert ttb.wide_arity() == jtb._wide_arity() == wide
    assert ttb.native_leaf_size() == jtb._native_leaf_size() == leaf
    table = PackedBvh(torch.zeros((1, 32)), torch.zeros((1, 40)), 1)
    assert (ttb.choose_route("auto", 1, False, table).closest != "plain") == kernels
    if "CHAMELEONRT_PACKET" in env:
        assert jtb._packet_enabled() == kernels


@pytest.mark.parametrize("width", [16, 32, 64, 24])
def test_check_takes_binary_bvh4_and_bvh8_rows_only(width):
    """The kernels' input check returns the arity of rows of 16, 32 and 64
    floats and refuses rows of 24 before any traversal."""
    R = 8
    table = PackedBvh(torch.zeros((5, width)), torch.zeros((3, 40)), 6)
    args = (torch.zeros((R, 3)), torch.ones((R, 3)), torch.zeros((R,)), torch.full((R,), 1e20),
            torch.ones((R,), dtype=torch.bool))
    if width == 24:
        with pytest.raises(ValueError, match="16 or 32 or 64 floats"):
            traverse_cuda._check(traverse_cuda.KERNELS["closest"], table, *args)
    else:
        assert traverse_cuda._check(traverse_cuda.KERNELS["closest"], table, *args) == (width // 8, 4, 7)


def test_spp3_frame_matches_jax_in_image_and_rays_traced(jax_frames, monkeypatch):
    """A frame at 3 samples per pixel (seeded frame_id * spp + 1 + s, as
    san_miguel_pbrt's 4 spp are): the same image as the JAX tpu backend's,
    and its count of rays traced, the numerator of every Mray/s, to within
    the bound below."""
    for k in ALL_SWITCHES:
        monkeypatch.delenv(k, raising=False)
    img, acc, st = _render_port(SPP_URI, SPP_RES, spp=SPP)
    img_ref, acc_ref, rays_ref = jax_frames["spp", SPP_URI]
    _assert_images_match(img_ref, img, acc_ref, acc)
    _, _, st1 = _render_port(SPP_URI, SPP_RES, spp=1)
    assert st.rays_traced > 2 * st1.rays_traced
    # XLA's compiled frame fuses multiply-adds and the port does not, so a
    # path can end one bounce apart where a shading decision sits on a
    # rounding edge. Measured on this frame: its second sample (seed 2) has
    # one path one bounce (a closest hit and two shadow rays) longer in the
    # port, 20,201 rays in all against 20,198; the JAX package traced op by
    # op (jax.disable_jit) counts the port's 6,701 for that sample where
    # its compiled frame counts 6,698. The bound: one bounce of one path a
    # sample.
    assert abs(st.rays_traced - rays_ref) <= 3 * SPP
