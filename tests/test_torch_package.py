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


def test_chip_smoke_knows_the_grid_packet_path_and_every_arity():
    """chip_smoke.py drives the grid_packet main path (5 B7a and 10 B7b
    launches a frame), pairs B7a/B7b with the plain flat walk, checks
    B1-B6d at arity 2, 4 and 8 on scenes that reach every one of them, and
    reads ptxas's registers and spills per kernel, arity and stack
    capacity, and the profile's template and packet kernel names, as
    launch-count keys."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda

    assert chip_smoke._main_paths()["grid_packet"][-1] == {"closest_packet": 5, "any_packet": 10}
    for closest, label, plain in ((True, "B7a", traverse.traverse_closest),
                                  (False, "B7b", traverse.traverse_any)):
        got = chip_smoke._kernel_pair("grid_packet", closest)
        assert got[0] == label and got[2] is plain
        assert got[1] is getattr(traverse_cuda, "traverse_closest_packet" if closest else "traverse_any_packet")
    labels = {chip_smoke._PATHS[p][k][0] for _, _, paths, _ in chip_smoke.ARITY_CASES for p in paths
              for k in (0, 1)}
    assert labels == {f"B{n}" for n in (1, 2, 3, 4)} | {f"B{n}{x}" for n in (5, 6) for x in "abcd"}
    assert chip_smoke.ARITIES == (2, 4, 8)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110any_kernelILi8ELi128EEEvPKfS2_' for 'sm_90a'",
        "    512 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 79 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121closest_stream_kernelILi4EEEvPKfS2_' for 'sm_90a'",
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121closest_packet_kernelEPKfS1_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers",
    ])
    assert chip_smoke._ptxas_table(log) == {
        ("any", 8, 128): {"stack_frame": 512, "spill_stores": 8, "spill_loads": 4, "registers": 79},
        ("closest_stream", 4, None): {"stack_frame": 32, "spill_stores": 0, "spill_loads": 0,
                                      "registers": 48},
        ("closest_packet", None, None): {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
                                         "registers": 40},
    }
    for name, key in (("_ZN12_GLOBAL__N_130any_unified_persistent_kernelILi2ELi64EEEvNS_6ParamsE",
                       "any_unified_persistent"),
                      ("void (anonymous namespace)::closest_stream_kernel<8>(float const*)", "closest_stream"),
                      ("(anonymous namespace)::any_packet_kernel(float const*, int)", "any_packet")):
        assert chip_smoke._TRAVERSAL_KERNEL.search(name).group(1) == key, name


def test_chip_smoke_holds_the_per_lane_walks_exactly():
    """B1, B2, B5a/B5b, B6a/B6b and B7a/B7b walk per lane over
    traverse_common.cuh's walks (the closest and the any walk over a flat
    table), as the two-level kernels do: every kernel whose per-lane stack
    the wrapper sizes is held exactly; ptxas's
    names of B7a's and B7b's instantiations (templates on the stack
    capacity alone, binary rows) read as arity 2 at that capacity."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    labels = {label for pair in chip_smoke._PATHS.values() for label, _, _ in pair}
    assert set(chip_smoke.PER_LANE) == labels
    assert {"B1", "B2", "B5a", "B5b", "B6a", "B6b", "B7a", "B7b"} <= set(chip_smoke.EXACT)
    assert set(chip_smoke.EXACT) == set(chip_smoke.PER_LANE)
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(k) + 7}{k}_kernelILi{cap}EEEvPKfS2_' "
        f"for 'sm_90a'\nptxas info    : Used {cap // 2 + len(k)} registers"
        for k in ("closest_packet", "any_packet") for cap in (64, 128))
    assert chip_smoke._ptxas_table(log) == {
        ("closest_packet", 2, 64): {"registers": 46}, ("closest_packet", 2, 128): {"registers": 78},
        ("any_packet", 2, 64): {"registers": 42}, ("any_packet", 2, 128): {"registers": 74}}
