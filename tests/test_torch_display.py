"""The port's display layer, arcball camera and JPEG encoder against the
JAX package's (chameleonrt_tpu/display/, utils/arcball.py,
utils/jpeg_encode.py), and the port CLI's two viewers: the stdin
interactive session and the browser viewer on a loopback port, on a CPU
`reference` backend (modelled on tests/test_display_arcball.py)."""

import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from chameleonrt_tpu.display import AnsiDisplay as JaxAnsiDisplay
from chameleonrt_tpu.utils.arcball import ArcballCamera as JaxArcball
from chameleonrt_tpu.utils.jpeg_encode import encode_jpeg as jax_encode_jpeg
from chameleonrt_tpu_torch import cli
from chameleonrt_tpu_torch.core import registry
from chameleonrt_tpu_torch.core.registry import register_backend
from chameleonrt_tpu_torch.display import AnsiDisplay, PngSequenceDisplay, make_display
from chameleonrt_tpu_torch.display.http_display import HttpDisplay
from chameleonrt_tpu_torch.engine.backend_reference import ReferenceBackend
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.utils.arcball import ArcballCamera
from chameleonrt_tpu_torch.utils.jpeg import decode_jpeg
from chameleonrt_tpu_torch.utils.jpeg_encode import encode_jpeg
from chameleonrt_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

CPU = "cpu_reference_display"


@pytest.fixture(autouse=True, scope="module")
def _cpu_backend():
    """The CPU backend under its own name for this file's tests, taken out
    of the port's registry afterwards."""
    register_backend(CPU, lambda **_: ReferenceBackend(device="cpu"))
    yield
    registry._REGISTRY.pop(CPU)


def _assert_same_camera(a, b):
    for name in ("eye", "dir", "up", "center", "rotation"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.distance == b.distance


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arcball_matches_jax_bit_for_bit(seed):
    """Seeded views and a seeded run of rotations (inside the ball and on
    its skirt), pans and zooms."""
    r = np.random.default_rng(seed)
    eye, center = r.uniform(-5, 5, 3), r.uniform(-1, 1, 3)
    up = np.array([0.0, 1.0, 0.0]) + r.uniform(-0.2, 0.2, 3)
    a, b = ArcballCamera(eye, center, up), JaxArcball(eye, center, up)
    _assert_same_camera(a, b)
    for _ in range(12):
        op = r.integers(3)
        if op == 0:
            p0, p1 = r.uniform(-1.3, 1.3, 2), r.uniform(-1.3, 1.3, 2)
            a.rotate(p0, p1)
            b.rotate(p0, p1)
        elif op == 1:
            delta = r.uniform(-0.2, 0.2, 2)
            a.pan(delta)
            b.pan(delta)
        else:
            amount = float(r.uniform(-1, 1))
            a.zoom(amount)
            b.zoom(amount)
        _assert_same_camera(a, b)


@pytest.mark.parametrize("shape, quality", [((8, 8, 3), 85), ((21, 37, 3), 80), ((30, 17), 50),
                                            ((64, 48, 3), 95)])
def test_encode_jpeg_matches_jax_byte_for_byte(shape, quality):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    data = encode_jpeg(img, quality=quality)
    assert data == jax_encode_jpeg(img, quality=quality)
    assert decode_jpeg(data).shape[:2] == shape[:2]


class _FakeBackend:
    def __init__(self, seed=0, h=12, w=10):
        self.img = np.random.default_rng(seed).integers(0, 256, (h, w, 4)).astype(np.uint8)
        self.frame_id = 1


@pytest.mark.parametrize("live, status", [(False, ""), (True, "frame 2/4"), (True, "")])
def test_ansi_display_matches_jax(live, status):
    """Two presents (the second rewinds the cursor when live), a status
    line, and a width the preview steps down to max_cols."""
    outs = []
    for cls in (AnsiDisplay, JaxAnsiDisplay):
        buf = io.StringIO()
        d = cls(max_cols=4, stream=buf, live=live)
        for seed in (0, 1):
            d.display(_FakeBackend(seed), status=status)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "\x1b[38;2;" in outs[0] and "▀" in outs[0]


def test_png_sequence_display(tmp_path):
    d = PngSequenceDisplay(prefix=str(tmp_path / "fr"))
    fake = _FakeBackend()
    d.display(fake)
    d.display(fake)
    assert np.array_equal(read_png(str(tmp_path / "fr-f1.png")), fake.img)
    assert not (tmp_path / "fr-f2.png").exists()


def test_display_factory():
    assert make_display("ansi").name() == "ANSI terminal"
    assert make_display("png", prefix="x").name() == "PNG sequence"
    http = make_display("http", port=0)
    try:
        assert http.name() == f"HTTP viewer on :{http.port}"
    finally:
        http.close()
    with pytest.raises(ValueError):
        make_display("vulkan")


def _post(base, event):
    req = urllib.request.Request(f"{base}/input", data=json.dumps(event).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=5)


def test_http_display_page_stats_input_stream_and_quit():
    disp = HttpDisplay(port=0)
    try:
        base = f"http://127.0.0.1:{disp.port}"
        page = urllib.request.urlopen(f"{base}/", timeout=5).read()
        assert b"/stream" in page and b"/stats" in page
        disp.set_stats(12.5, 3.2e6, 7)
        fake = _FakeBackend()
        disp.display(fake)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=5).read())
        assert stats["ms_per_frame"] == 12.5 and stats["frame_id"] == 7
        assert (stats["width"], stats["height"]) == (10, 12)
        assert _post(base, {"type": "rotate", "x0": 0, "y0": 0, "x1": 0.1, "y1": 0.2}).status == 204
        evs = disp.poll_events()
        assert evs and evs[0]["type"] == "rotate"
        resp = urllib.request.urlopen(f"{base}/stream", timeout=5)
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        assert b"crtframe" in resp.readline()
        headers = {}
        while True:
            ln = resp.readline().strip()
            if not ln:
                break
            k, v = ln.split(b":", 1)
            headers[k.strip().lower()] = v.strip()
        jpeg = resp.read(int(headers[b"content-length"]))
        assert jpeg == encode_jpeg(fake.img[..., :3], quality=80)
        resp.close()
        _post(base, {"type": "quit"})
        assert disp.closed
    finally:
        disp.close()


def test_interactive_session(tmp_path, monkeypatch, capsys):
    out_png, save_png = tmp_path / "ia.png", tmp_path / "snap.png"
    script = ("p\nframe 2\nrotate 0 0 0.2 0.1\nframe\npan 0.1 0\nzoom 1\nframe\nshow\n"
              f"save {save_png}\nstats\nbogus\nq\n")
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    rc = cli.main([CPU, "proc://cornell", "-img", "16", "16", "-interactive", "-display", "none",
                   "-o", str(out_png)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "-eye " in out and "-center " in out and "-fov " in out  # `p`
    assert "ms/frame" in out and "frame_id=1" in out  # stats after the last frame
    assert "unknown command 'bogus'" in out
    assert "\x1b[38;2;" in out  # show
    assert out_png.exists() and save_png.exists()


def test_http_viewer_renders_and_quits(tmp_path, monkeypatch):
    """run_http_viewer on the CPU reference backend: frames are published
    with their stats, an arcball drag arrives over HTTP, a quit ends the
    loop, and -o is saved."""
    scene = load_scene("proc://cornell")
    backend = ReferenceBackend(device="cpu")
    backend.initialize(16, 16)
    backend.set_scene(scene)
    cam = scene.cameras[0]
    made = []
    init = HttpDisplay.__init__

    def on_free_port(self, port=8000, quality=80, host="127.0.0.1"):
        init(self, port=0, quality=quality, host=host)
        made.append(self)

    monkeypatch.setattr(HttpDisplay, "__init__", on_free_port)
    frames_seen = []

    def drive():
        for _ in range(200):
            if made and made[0]._frame_no >= 2:
                break
            time.sleep(0.05)
        base = f"http://127.0.0.1:{made[0].port}"
        frames_seen.append(json.loads(urllib.request.urlopen(f"{base}/stats", timeout=5).read()))
        _post(base, {"type": "rotate", "x0": 0, "y0": 0, "x1": 0.2, "y1": 0})
        time.sleep(0.3)
        _post(base, {"type": "quit"})

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    out = tmp_path / "viewer.png"
    rc = cli.run_http_viewer(backend, cam.position, cam.center, cam.up, cam.fov_y,
                             {"display": "http:0", "out": str(out)})
    th.join(timeout=30)
    assert not th.is_alive()
    assert rc == 0 and out.exists()
    assert frames_seen and frames_seen[0]["width"] == 16 and frames_seen[0]["frame_id"] >= 1
    assert made[0].closed
