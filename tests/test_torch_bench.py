"""The port's bench (chameleonrt_tpu_torch/bench.py) against the JAX
package's bench.py.

- CONFIGS, TIME_BUDGET_S and PARITY_W/H equal bench.py's (the root
  module imports only numpy at its top, and nothing of JAX until a
  function runs).
- run_config(device="cpu") on proc://cornell at 32x32, 2 frames, 1 spp
  against bench.run_config on the JAX CPU backend (in a process of its
  own, tests/subproc_render.py says why): the same keys; equal tris,
  total_tris, spp and res; rays_per_frame within C2's allowance (XLA's
  fused multiply-adds can end one path one bounce apart: a closest hit and
  two shadow rays a sample, tests/test_torch_switches.py).
- gen://san_miguel resolves through the port's generator (stubbed) into
  bench.py's directory.
- run_parity(device="cpu") returns bench.py's keys, its kernel rows
  skipped, and runs the image gate: `cuda` against `reference` on the
  gate's scene, here at 32x18 in place of 128x72 (patched, so that the
  brute force stays small on the CPU).
- main() raises without a card before any config runs; main(device="cpu")
  with tiny configs prints one JSON line whose keys are bench.py's, and
  records a config that raises as "FAILED: ...".
- chip_smoke.py drives every config at its scene and size.
"""

import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

import bench
from chameleonrt_tpu_torch import bench as tbench
from chameleonrt_tpu_torch.scene import pbrt_gen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = ("proc://cornell", 32, 32, 2, 1)
RAYS_ALLOWANCE = 3  # C2: one bounce of one path a sample, 1 spp

_JAX_RUN_CONFIG = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import bench
url, w, h, frames, spp = json.loads(sys.argv[1])
print(json.dumps(bench.run_config(url, w, h, frames, spp)))
"""


@pytest.fixture(scope="module")
def jax_cornell():
    """bench.run_config on the JAX CPU backend, on CORNELL."""
    out = subprocess.run([sys.executable, "-c", _JAX_RUN_CONFIG, json.dumps(CORNELL)], cwd=ROOT,
                         check=True, timeout=600, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_configs_equal_bench_py():
    assert tbench.CONFIGS == bench.CONFIGS
    assert tbench.TIME_BUDGET_S == bench.TIME_BUDGET_S
    assert (tbench.PARITY_W, tbench.PARITY_H) == (bench.PARITY_W, bench.PARITY_H)
    assert [c[0] for c in tbench.CONFIGS] == [
        "sponza_proxy", "cornell", "instanced", "rungholt_city", "san_miguel_pbrt",
        "rungholt_soup"]


def test_run_config_matches_jax_bench(jax_cornell):
    got = tbench.run_config(*CORNELL, device="cpu")
    assert set(got) == set(jax_cornell)
    for k in ("tris", "total_tris", "spp", "res"):
        assert got[k] == jax_cornell[k], k
    assert abs(got["rays_per_frame"] - jax_cornell["rays_per_frame"]) <= RAYS_ALLOWANCE
    assert got["rays_per_frame"] > 32 * 32  # more than the primary rays
    assert got["mrays_per_s"] > 0 and got["ms_per_frame"] > 0 and got["fps"] > 0
    assert got["scene_build_s"] >= 0


class _Resolved(Exception):
    pass


def test_san_miguel_resolves_through_the_ports_generator_into_bench_dir(monkeypatch):
    """The port's generator is stubbed to record its directory and hand
    back a small scene; bench.py's directory comes from bench.run_config
    itself, whose generator is stubbed to stop it there."""
    seen = []

    def port_stub(out_dir, **kwargs):
        seen.append(out_dir)
        return "proc://cornell"

    def jax_stub(out_dir, **kwargs):
        raise _Resolved(out_dir)

    monkeypatch.setattr(pbrt_gen, "generate_san_miguel_proxy", port_stub)
    from chameleonrt_tpu.scene import pbrt_gen as jax_pbrt_gen

    monkeypatch.setattr(jax_pbrt_gen, "generate_san_miguel_proxy", jax_stub)
    with pytest.raises(_Resolved) as jax_dir:
        bench.run_config("gen://san_miguel", 8, 8, 1, 4)
    got = tbench.run_config("gen://san_miguel", 8, 8, 1, 4, device="cpu")
    assert seen == [jax_dir.value.args[0]]
    assert seen[0] == os.path.join(tempfile.gettempdir(), "crt_san_miguel")
    assert got["spp"] == 4 and got["res"] == "8x8" and got["tris"] == 34


def test_run_parity_on_cpu_skips_kernels_and_runs_the_image_gate(monkeypatch):
    monkeypatch.setattr(tbench, "IMAGE_W", 32)
    monkeypatch.setattr(tbench, "IMAGE_H", 18)
    out = tbench.run_parity(device="cpu")
    # bench.py's keys on the chip it runs its kernels on (bench.py:104-194)
    assert set(out) == {"flat", "unified", "textured_image", "ok"}
    for row in ("flat", "unified"):
        assert out[row] == "skipped (device cpu: the kernels run on the card)"
    assert set(out["textured_image"]) == {"mean_abs_diff_u8", "ok"}
    assert out["textured_image"]["mean_abs_diff_u8"] < 1.0
    assert out["textured_image"]["ok"] is True and out["ok"] is True


def test_main_raises_without_a_card(monkeypatch):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "run_parity", lambda *a, **k: ran.append("parity"))
    monkeypatch.setattr(tbench, "run_config", lambda *a, **k: ran.append("config"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main()
    assert ran == []


def _bench_py_line(monkeypatch, capsys):
    """The JSON line of bench.py's own main, its parity and configs
    stubbed (each config returns the port's keys)."""
    row = tbench.run_config("proc://cornell", 8, 8, 1, 1, device="cpu")
    monkeypatch.setattr(bench, "CONFIGS", [("sponza_proxy", "x", 8, 8, 1, 1)])
    monkeypatch.setattr(bench, "run_parity", lambda: {"ok": True})
    monkeypatch.setattr(bench, "run_config", lambda *a, **k: dict(row))
    assert bench.main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_on_cpu_prints_bench_py_line(monkeypatch, capsys):
    want = _bench_py_line(monkeypatch, capsys)
    monkeypatch.setattr(tbench, "IMAGE_W", 32)
    monkeypatch.setattr(tbench, "IMAGE_H", 18)
    monkeypatch.setattr(tbench, "CONFIGS", [
        ("sponza_proxy", "proc://cornell", 16, 16, 1, 1),
        ("broken", "proc://no_such_scene", 8, 8, 1, 1),
        ("cornell", "proc://cornell", 8, 8, 2, 1),
    ])
    assert tbench.main(device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == set(want)
    assert set(line["detail"]) == set(want["detail"]) == {"device", "configs", "parity"}
    assert line["unit"] == want["unit"] == "Mray/s"
    assert line["detail"]["device"] == "cpu"
    configs = line["detail"]["configs"]
    assert set(configs["sponza_proxy"]) == set(want["detail"]["configs"]["sponza_proxy"])
    assert configs["broken"].startswith("FAILED: ")
    assert configs["cornell"]["res"] == "8x8"
    assert line["value"] == round(configs["sponza_proxy"]["mrays_per_s"], 2)
    assert line["vs_baseline"] == round(configs["sponza_proxy"]["mrays_per_s"] / 100.0, 4)
    assert line["detail"]["parity"]["ok"] is True


def test_chip_smoke_drives_every_bench_config_at_its_size():
    """chip_smoke.py renders each config of the port's bench in its own
    process too, at the config's scene and size: the hall, San Miguel and
    the city through its main paths, the other three through _bench_paths,
    at 1 spp with 5 closest and 10 any launches a frame of the route each
    takes."""
    import chip_smoke as cs

    extra = cs._bench_paths()
    assert {p: args[-1] for p, args in extra.items()} == {
        "cornell": {"closest": 5, "any": 10},
        "instanced": {"closest_unified": 5, "any_unified": 10},
        "soup": {"closest_stream": 5, "any_stream": 10},
    }
    driven = {args[:3] for args in (*cs._main_paths().values(), *extra.values())}
    for name, url, w, h, frames, spp in tbench.CONFIGS:
        assert (url, w, h) in driven, name
    for path, (url, w, h, spp, frames, _) in extra.items():
        assert (url, w, h, spp) in {(c[1], c[2], c[3], c[5]) for c in tbench.CONFIGS}
        assert spp == 1 and frames == cs.BENCH_PATH_TIMED_FRAMES
