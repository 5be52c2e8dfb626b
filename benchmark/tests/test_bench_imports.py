"""No module the benchmark runs loads jax, jaxlib, flax or the JAX package
(chameleonrt_tpu), by top-level name compared whole, and the reference
imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import spec

ROOT = os.path.dirname(spec.BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "chameleonrt_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    files = [f for f in glob.glob(os.path.join(spec.BENCH_DIR, "**", "*.py"), recursive=True)
             if f"{os.sep}tests{os.sep}" not in f]
    assert files
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in glob.glob(os.path.join(spec.BENCH_DIR, "reference", "*.py")):
        assert set(_imports(f)) <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}, f
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.path, benchmark.reference.bvh;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"chameleonrt_tpu_torch"})


def test_a_whole_run_loads_no_jax(tmp_path):
    from benchmark.tests import tiny

    bench_dir = tiny.make_copy(str(tmp_path), [("i-cornell", "cornell_box")])
    code = ("import sys, time; sys.path.insert(0, %r); from benchmark.harness import bench, spec;"
            "bench.run_cell(spec.load_cell('i-cornell', %r), 5, 0.2, False, time.perf_counter(), device='cpu');"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % (ROOT, bench_dir))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         timeout=600).stdout.strip().splitlines()[-1]
    loaded = set(eval(out))
    assert "chameleonrt_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
