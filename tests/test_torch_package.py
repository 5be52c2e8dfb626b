"""The port package: importing it pulls in no JAX and registers the `cuda`
backend; a CUDA backend refuses to start where there is no card. Each
import check runs in a fresh interpreter, since the test process itself
has JAX loaded."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import chameleonrt_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_import_leaves_jax_out_and_registers_cuda():
    out = _fresh(
        "import sys, chameleonrt_tpu_torch\n"
        "from chameleonrt_tpu.core.registry import list_backends\n"
        "print('jax' in sys.modules, 'cuda' in list_backends())\n"
    )
    assert out.split() == ["False", "True"]


def test_no_module_of_the_port_imports_jax():
    names = [
        m.name
        for m in pkgutil.walk_packages(chameleonrt_tpu_torch.__path__, "chameleonrt_tpu_torch.")
    ]
    assert "chameleonrt_tpu_torch.ops.traverse_cuda" in names
    out = _fresh(
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    assert out.strip() == "[]"


def test_cuda_backend_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from chameleonrt_tpu.core import get_backend

    b = get_backend("cuda")
    assert b.device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        b.initialize(8, 8)


def test_cli_usage_and_missing_card(capsys):
    from chameleonrt_tpu_torch import cli

    assert cli.parse_args(["cuda", "proc://cornell", "-img", "64", "32", "-benchmark-frames", "3"]) == {
        "img": (64, 32), "benchmark_frames": 3, "out": "chameleonrt_cuda_out.png",
        "backend": "cuda", "scene": "proc://cornell",
    }
    assert cli.parse_args(["cuda"]) is None
    assert cli.parse_args(["cuda", "proc://cornell", "-spp", "2"]) is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["cuda", "proc://cornell", "-img", "8", "8"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
