"""Sets of runs of one cell, each run a process of its own as the benchmark's
command makes it, and the spread of each metric in each set: what the
bounds in BENCHMARK.json are set from.

    python3 benchmark/sets.py --workload <cell> --seeds 1,2,3,4,5,6 --sets A,B \
        --seconds <run_seconds> [--trace 1] --out <dir>
    python3 benchmark/sets.py --out <dir>          # the summary of runs made before

Every set runs every seed, in order, so two sets hold the same seeds. Each
run's standard output and error go to <dir>/<set><i>.out and .err. The
summary gives, for each set and metric, the median and the spread: the
distance between the first and third quartiles (statistics.quantiles,
n=4) over the median; then each run's `correct` and its checks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def last_line(path: str):
    with open(path) as f:
        lines = [ln for ln in f if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def summary(out: str) -> None:
    runs = {}
    for path in sorted(glob.glob(os.path.join(out, "*.out"))):
        runs[os.path.basename(path)[:-4]] = last_line(path)
    for tag in sorted({name.rstrip("0123456789") for name in runs}):
        results = [runs[n] for n in sorted(runs, key=lambda n: (len(n), n))
                   if n.rstrip("0123456789") == tag and runs[n]]
        values = {}
        for r in results:
            for k, v in r["metrics"].items():
                values.setdefault(k, []).append(v["value"])
        for k, v in values.items():
            s = f"{spread(v) * 100:.2f}%" if len(v) >= 2 else "-"
            print(f"set {tag} {k}: n {len(v)}, median {statistics.median(v)!r}, spread {s}, values {v}")
    for name, r in runs.items():
        if r is None:
            print(f"{name}: no result")
        else:
            checks = {k: c["value"] for k, c in r.get("checks", {}).items()}
            print(f"{name}: correct {r['correct']}, attempted {r['attempted']}, failed {r['failed']}, "
                  f"peak {r['device']['memory_peak_bytes']}, checks {checks}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload")
    parser.add_argument("--seeds", default="", help="comma-separated")
    parser.add_argument("--sets", default="A", help="comma-separated set names")
    parser.add_argument("--seconds", type=float, default=30)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    seeds = [s for s in args.seeds.split(",") if s]
    for tag in args.sets.split(",") if seeds else []:
        for i, seed in enumerate(seeds, 1):
            base = os.path.join(args.out, f"{tag}{i}")
            with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
                rc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                                     "--workload", args.workload, "--seed", seed,
                                     "--seconds", str(args.seconds), "--trace", str(args.trace)],
                                    cwd=ROOT, stdout=out, stderr=err).returncode
            print(f"{args.workload} {tag}{i} seed {seed} rc {rc}", flush=True)
    summary(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
