"""The port's command line (chameleonrt_tpu_torch/cli.py) against
chameleonrt_tpu/cli.py.

- parse_args gives the JAX CLI's options for every flag, with two stated
  exceptions: the default -o (chameleonrt_cuda_out.png), and -devices and
  -rebalance, which the port refuses with a clear error (it renders on one
  card).
- The error paths of tests/test_checkpoint_cli.py.
- With a CPU backend registered through the port's registry (the CLI has
  no CPU flag): -spp, -validation, -checkpoint/-resume, -profile, and the
  flags that change the view or the materials (-camera, -eye/-center/-up/
  -fov, -mat-mode white_diffuse), whose images are held to the JAX CLI's
  under tests/test_cross_backend.py's _assert_images_match.
"""

import json

import numpy as np
import pytest
import torch

from chameleonrt_tpu import cli as jax_cli
from chameleonrt_tpu_torch import cli
from chameleonrt_tpu_torch.core import registry
from chameleonrt_tpu_torch.core.registry import register_backend
from chameleonrt_tpu_torch.engine.backend_reference import ReferenceBackend
from chameleonrt_tpu_torch.scene.types import Camera
from chameleonrt_tpu_torch.utils.image_io import read_image
from chameleonrt_tpu_torch.utils.util import get_device_brand
from test_cross_backend import _assert_images_match

torch.set_num_threads(1)

CPU = "cpu_reference"
RES = ["-img", "16", "16"]


class _Recording(ReferenceBackend):
    """The CPU reference backend, keeping every frame's RenderStats and
    the primary rays (the closest-hit calls from t_min = 0) it traced."""

    made = []

    def __init__(self, **_):
        super().__init__(device="cpu")
        self.stats, self.primary_rays = [], 0
        _Recording.made.append(self)

    def make_trace_fns(self, meta):
        closest, any_hit = super().make_trace_fns(meta)

        def counted(flat, orig, dir, t_min, active):
            if t_min == 0.0:
                self.primary_rays += int(active.sum())
            return closest(flat, orig, dir, t_min, active)

        return counted, any_hit

    def render(self, *args, **kwargs):
        st = super().render(*args, **kwargs)
        self.stats.append(st)
        return st


@pytest.fixture(autouse=True, scope="module")
def _cpu_backend():
    """The CPU backend under its own name for this file's tests, taken out
    of the port's registry afterwards."""
    register_backend(CPU, _Recording)
    yield
    registry._REGISTRY.pop(CPU)


def _run(argv, tmp_path, name="out.png"):
    """The port's CLI on the CPU backend: (exit code, the backend)."""
    _Recording.made.clear()
    rc = cli.main([CPU, argv[0], *RES, "-display", "none", "-o", str(tmp_path / name), *argv[1:]])
    return rc, (_Recording.made[-1] if _Recording.made else None)


# every flag of chameleonrt_tpu/cli.py but -devices and -rebalance
ARGV = {
    "defaults": ["be", "s.obj"],
    "view": ["be", "s.obj", "-eye", "1", "2", "3", "-center", "0", "1", "0", "-up", "0", "0", "1",
             "-fov", "45"],
    "samples": ["be", "s.obj", "-spp", "4", "-camera", "2", "-img", "64", "32"],
    "validation": ["be", "s.obj", "-mat-mode", "white_diffuse", "-validation", "v_",
                   "-benchmark-frames", "3"],
    "frames": ["be", "s.obj", "-frames", "5", "-o", "x.png", "-interactive", "-mat-mode", "default"],
    "state": ["be", "s.obj", "-resume", "a.npz", "-checkpoint", "b.npz", "-profile", "prof"],
    "http_port": ["be", "s.obj", "-display", "http:9000"],
    "http_host": ["be", "s.obj", "-display", "http:0.0.0.0:8001"],
    "http": ["be", "s.obj", "-display", "http"],
    "ansi": ["be", "s.obj", "-display", "ansi"],
    "none": ["be", "s.obj", "-display", "none"],
    "flag_first": ["-fov", "30", "be", "s.obj"],
    "help": ["be", "s.obj", "-h"],
    "one_positional": ["be"],
    "unknown_flag": ["be", "s.obj", "-nope"],
    "short_vec3": ["be", "s.obj", "-eye", "1", "2"],
    "missing_value": ["be", "s.obj", "-spp"],
    "bad_int": ["be", "s.obj", "-img", "3", "x"],
    "bad_mat_mode": ["be", "s.obj", "-mat-mode", "shiny"],
    "bad_display": ["be", "s.obj", "-display", "vulkan"],
    "bad_http_port": ["be", "s.obj", "-display", "http:abc"],
}


@pytest.mark.parametrize("case", sorted(ARGV))
def test_parse_args_matches_jax(case, capsys):
    argv = ARGV[case]
    want, got = jax_cli.parse_args(argv), cli.parse_args(argv)
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "out" and "-o" not in argv:
            assert (value, got[key]) == ("chameleonrt_tpu_out.png", "chameleonrt_cuda_out.png")
        elif key == "mat_mode":
            assert got[key].name == value.name
        elif isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("argv", [["-devices", "2"], ["-devices", "all"], ["-rebalance"]],
                         ids=["devices_2", "devices_all", "rebalance"])
def test_multi_device_flags_are_refused(argv, capsys):
    assert jax_cli.parse_args(["be", "s.obj", *argv]) is not None
    assert cli.parse_args(["be", "s.obj", *argv]) is None
    err = capsys.readouterr().err
    assert f"Error: {argv[0]} is not supported" in err and "one GPU" in err
    assert cli.main([CPU, "proc://cornell", *argv]) == 1


@pytest.mark.parametrize("argv, message", [
    (["proc://nope"], "Error:"),
    (["/does/not/exist.obj"], "Error:"),
    (["proc://cornell", "-mat-mode", "shiny"], "unknown material mode"),
    (["proc://cornell", "-eye", "1", "2"], "-eye expects 3 values"),
    (["proc://cornell", "-display", "http:x"], "needs an integer port"),
])
def test_clean_errors(argv, message, capsys):
    assert cli.main([CPU, *argv]) == 1
    err = capsys.readouterr().err
    assert message in err and "Traceback" not in err


def test_spp_doubles_the_primary_rays(tmp_path):
    runs = {}
    for spp in (1, 2):
        rc, b = _run(["proc://cornell", "-frames", "2", "-spp", str(spp)], tmp_path)
        assert rc == 0 and b.samples_per_pixel == spp
        runs[spp] = b
    assert runs[1].primary_rays == 2 * 16 * 16
    assert runs[2].primary_rays == 2 * runs[1].primary_rays
    assert runs[2].stats[-1].rays_traced > 1.5 * runs[1].stats[-1].rays_traced


def test_validation_writes_every_frame(tmp_path, capsys):
    prefix = str(tmp_path / "v_")
    rc, b = _run(["proc://cornell", "-frames", "3", "-validation", prefix], tmp_path)
    assert rc == 0
    for f in range(3):
        img = read_image(f"{prefix}{CPU}-f{f}.png")
        assert img.shape[:2] == (16, 16)
    assert not (tmp_path / f"v_{CPU}-f3.png").exists()
    # the last frame's file is the saved output
    assert np.array_equal(read_image(f"{prefix}{CPU}-f2.png"), read_image(str(tmp_path / "out.png")))
    out = capsys.readouterr().out
    assert f"Device: {get_device_brand()}" in out and "# Unique Triangles:" in out


def test_checkpoint_then_resume_continues_the_frame_count(tmp_path, capsys):
    first, second = str(tmp_path / "s.npz"), str(tmp_path / "t.npz")
    rc, a = _run(["proc://cornell", "-frames", "3", "-checkpoint", first], tmp_path)
    assert rc == 0 and a.frame_id == 3
    rc, b = _run(["proc://cornell", "-frames", "2", "-resume", first, "-checkpoint", second],
                 tmp_path)
    assert rc == 0 and b.frame_id == 5
    assert "Resumed from" in capsys.readouterr().out
    with np.load(second) as z:
        assert int(z["frame_id"]) == 5
    # the same 5 frames in one run
    rc, c = _run(["proc://cornell", "-frames", "5"], tmp_path)
    assert torch.allclose(b._accum, c._accum, rtol=1e-5, atol=1e-6)


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    rc, _ = _run(["proc://cornell", "-frames", "1", "-profile", str(prof)], tmp_path)
    assert rc == 0
    with open(prof / cli.PROFILE_TRACE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


@pytest.fixture
def two_cameras(monkeypatch):
    """Both CLIs' proc://cornell with a second camera, moved to the left
    and looking at the back wall's right half."""
    import chameleonrt_tpu.cli as jc
    from chameleonrt_tpu.scene.types import Camera as JaxCamera

    def wrap(module, cam_cls):
        load = module.load_scene

        def load_scene(path, mode):
            scene = load(path, mode)
            c = scene.cameras[0]
            scene.cameras.append(cam_cls(position=c.position + np.float32([-0.4, 0.1, 0.0]),
                                         center=c.center + np.float32([0.3, 0.0, 0.0]),
                                         up=c.up, fov_y=c.fov_y * 0.8))
            return scene

        monkeypatch.setattr(module, "load_scene", load_scene)

    wrap(jc, JaxCamera)
    wrap(cli, Camera)


VIEW_FLAGS = {
    "camera": ["-camera", "1"],
    "eye_center_up_fov": ["-eye", "0.3", "0.5", "2.5", "-center", "0", "0.2", "0", "-up", "0.1",
                          "1", "0", "-fov", "50"],
    "white_diffuse": ["-mat-mode", "white_diffuse"],
}


@pytest.mark.parametrize("case", sorted(VIEW_FLAGS))
def test_view_and_material_flags_change_the_image_as_in_jax(case, two_cameras, tmp_path,
                                                            monkeypatch):
    flags = ["-frames", "2", *VIEW_FLAGS[case]]
    rc, base = _run(["proc://cornell", "-frames", "2"], tmp_path, "base.png")
    assert rc == 0
    rc, port = _run(["proc://cornell", *flags], tmp_path, "port.png")
    assert rc == 0
    jax_made = []
    jax_get = jax_cli.get_backend

    def jax_backend(name, **kw):
        jax_made.append(jax_get(name, **kw))
        return jax_made[-1]

    monkeypatch.setattr(jax_cli, "get_backend", jax_backend)
    assert jax_cli.main(["reference", "proc://cornell", *RES, "-display", "none",
                         "-o", str(tmp_path / "jax.png"), *flags]) == 0
    jb = jax_made[-1]
    img, jimg = port.img[..., :3].astype(np.float32), jb.img[..., :3].astype(np.float32)
    assert np.abs(img - base.img[..., :3].astype(np.float32)).mean() > 5.0
    _assert_images_match(jimg, img, np.asarray(jb._accum), port._accum.numpy())
