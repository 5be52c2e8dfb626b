"""The port package: importing it pulls in neither JAX nor the JAX package,
and its own registry knows the `cuda` backend; a CUDA backend refuses to
start where there is no card. Each import check runs in a fresh
interpreter, since the test process itself has JAX loaded."""

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
        "from chameleonrt_tpu_torch.core.registry import list_backends\n"
        "print('jax' in sys.modules, 'chameleonrt_tpu' in sys.modules, 'cuda' in list_backends())\n"
    )
    assert out.split() == ["False", "False", "True"]


def test_no_module_of_the_port_imports_jax():
    names = [
        m.name
        for m in pkgutil.walk_packages(chameleonrt_tpu_torch.__path__, "chameleonrt_tpu_torch.")
    ]
    assert "chameleonrt_tpu_torch.ops.traverse_cuda" in names
    out = _fresh(
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'chameleonrt_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_cuda_backend_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from chameleonrt_tpu_torch.core import get_backend

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


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card_or_the_repo(where, tmp_path):
    """No result, and a nonzero exit, where there is no card or where the
    directory holds chip_smoke.py and nothing else of the repository."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(script), env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_profile_helpers():
    """The main paths' profile: busy time (a union of intervals) and its reading
    of traversal kernels' names, mangled or not, as launch-count keys."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke._union_us([(5, 6), (0, 2), (1, 3), (5.5, 5.7), (3, 3.5)]) == 4.5
    assert chip_smoke._union_us([]) == 0.0
    from chameleonrt_tpu_torch.ops.traverse_cuda import LAUNCHES

    for key in LAUNCHES:
        for name in (f"_ZN51_GLOBAL__N__51879157_18_traverse_stream_cu_09ff73a4{len(key) + 7}{key}_kernelEPKf",
                     f"(anonymous namespace)::{key}_kernel(float const*, int)"):
            assert chip_smoke._TRAVERSAL_KERNEL.search(name).group(1) == key, name
    for name in ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
                 "(anonymous namespace)::many_kernel(float const*)", "Memcpy HtoD (Pageable -> Device)"):
        assert chip_smoke._TRAVERSAL_KERNEL.search(name) is None, name
