"""The benchmark's command, as BENCHMARK.json names it. Without a card it
prints no result and exits non-zero; on the card (marker `card`) a cell
cut to a tiny size prints the contract's last line, and a directory that
holds only BENCHMARK.json and the benchmark prints none.

    python -m pytest benchmark/tests -m card     # on the card
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests import tiny


def _run(root, *args, timeout=900):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=root, capture_output=True,
                          text=True, timeout=timeout)


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = _run(tiny.ROOT, "--workload", "cornell-960-1spp", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_last_line_on_the_card(card, tmp_path, trace):
    for name in ("chameleonrt_tpu_torch", "native"):  # the program and its native builder's sources
        shutil.copytree(os.path.join(tiny.ROOT, name), tmp_path / name,
                        ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))
    tiny.make_copy(str(tmp_path), [("card-cornell", "cornell_box")], width=128, height=72)
    res = _run(str(tmp_path), "--workload", "card-cornell", "--seed", str(2**31 + 5), "--seconds", "2",
               "--trace", trace)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    if trace == "1":
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert {"kernels_per_frame", "traversal_roofline", "device_idle_share"} <= set(line["metrics"])
        assert 0 < line["metrics"]["traversal_roofline"]["value"] <= 105
    else:
        assert {"frame_ms", "mrays_per_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.card
def test_the_benchmark_alone_prints_nothing(card, tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(str(tmp_path), "--workload", "cornell-960-1spp", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert res.returncode != 0 and res.stdout.strip() == ""
