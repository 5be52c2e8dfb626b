#!/usr/bin/env python3
"""Time the two-level traversal kernels of several checkouts in turns on one GPU.

    python3 scripts/kernel_turns.py --out chiprun_out/turns.json TREE [TREE ...]

Each TREE is a checkout of this repository (a `git archive` of a commit, or
a copy with its csrc/ edited). The wavefronts are made once, by this
checkout's chip_smoke.py helpers: sorted primary rays and diffuse-bounce
rays at 1280x720 on the San Miguel proxy, the large San Miguel proxy and a
576-instance grid, and on the San Miguel proxy also the two masked shadow-ray
wavefronts (light samples, bsdf samples) of the first bounce of one 1-spp
1280x720 frame, captured as chip_smoke.py captures a main path's shadow rays
(any hit only), with the plain walk's results on each. Then one worker
process a tree builds that tree's kernels and binds them through that
tree's own wrappers, checks its six two-level kernels (B3, B4, B5c, B5d,
B6c, B6d) against the plain results bit for bit, and times them when asked.
The trees are visited in turns, 1-2-...-n-n-...-2-1, for --rounds rounds;
each visit takes the median of --reps CUDA-event timings of every kernel
on every wavefront after a warmup, and the result is the mean of a tree's
medians with their range. A tree that fails its check is reported and not
timed. Any hit runs at t_max = 1.001 x the closest hit on primary rays and
0.999 x on bounce rays, as chip_smoke.py's bounds do, and on the shadow
wavefronts at their own t_max and mask.

Prints a table and writes every median, each tree's ptxas registers and
spills of those kernels, and the card's name and power limit to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_576 = "proc://instances?nx=24&ny=24"
BUILD_AT_ONCE = 3
KERNELS = {  # label: (wrapper, closest hit?)
    "B3": ("traverse_closest_unified", True),
    "B5c": ("traverse_closest_unified_stream", True),
    "B6c": ("traverse_closest_unified_persistent", True),
    "B4": ("traverse_any_unified", False),
    "B5d": ("traverse_any_unified_stream", False),
    "B6d": ("traverse_any_unified_persistent", False),
}

# One tree's worker: builds and binds the tree's kernels, then answers one
# JSON command a line on stdin with one JSON line on stdout.
WORKER = r"""
import json, os, sys, time
tree, cases_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import UnifiedBvh
from chameleonrt_tpu_torch.ops import traverse_cuda
import chip_smoke

def reply(x):
    sys.stdout.write(json.dumps(x) + "\n")
    sys.stdout.flush()

t0 = time.perf_counter()
_build.kernels()
build_s = time.perf_counter() - t0
with open(_build.kernel_library_path()[: -len(".so")] + ".log") as f:
    ptxas = chip_smoke._ptxas_table(f.read())
ptxas = {"@".join(map(str, k)): v for k, v in ptxas.items() if "unified" in k[0]}
saved = torch.load(cases_path)
tables = {k: UnifiedBvh(**{f: v.cuda() if torch.is_tensor(v) else v for f, v in t.items()})
          for k, t in saved["tables"].items()}
cases = {}
for name, c in saved["cases"].items():
    table = tables[c["scene"]]
    cases[name] = {kind: ((table,) + tuple(x.cuda() for x in c[kind]),
                          tuple(x.cuda() for x in c["want_" + kind]))
                   for kind in ("closest", "any") if kind in c}
reply({"ready": True, "build_s": build_s, "ptxas": ptxas})
for line in sys.stdin:
    cmd = json.loads(line)
    if cmd["op"] == "check":
        out = {}
        for label, (wrapper, closest) in cmd["kernels"].items():
            fn = getattr(traverse_cuda, wrapper)
            kind = "closest" if closest else "any"
            for name, c in cases.items():
                if kind in c:
                    args, want = c[kind]
                    got = fn(*args)
                    got = got if closest else (got,)
                    out[f"{label}@{name}"] = all(torch.equal(g, w) for g, w in zip(got, want))
        reply(out)
    elif cmd["op"] == "time":
        out = {}
        for label, (wrapper, closest) in cmd["kernels"].items():
            fn = getattr(traverse_cuda, wrapper)
            kind = "closest" if closest else "any"
            for name, c in cases.items():
                if kind in c:
                    args = c[kind][0]
                    out[f"{label}@{name}"] = chip_smoke._median_ms(torch, lambda: fn(*args), cmd["reps"])
        reply(out)
    else:
        break
"""


def _cases(torch, path):
    """Make the wavefronts and the plain results, and save them (on the CPU)
    at path: {"tables": {scene: UnifiedBvh fields}, "cases": {case: {"scene",
    "closest", "any", "want_closest", "want_any"}}}."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from chameleonrt_tpu_torch.ops import traverse
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.math import EPSILON

    tables, out = {}, {}
    for scene_name, uri in (("san_miguel", cs.SAN_MIGUEL), ("large_proxy", cs.SAN_MIGUEL_LARGE),
                            ("grid576", GRID_576)):
        scene, flat, meta = cs._scene_tables(torch, uri)
        table = flat.blas[0].any
        tables[scene_name] = {k: v.cpu() if torch.is_tensor(v) else int(v)
                              for k, v in table._asdict().items()}
        orig, dirs, active = cs._primary_wavefront(torch, scene, cs.MAIN_W, cs.MAIN_H)
        R = orig.shape[0]
        t_min = torch.zeros((R,), device="cuda")
        for kind, factor in (("primary", 1.001), ("bounce", 0.999)):
            t_max = torch.full((R,), T_MAX, device="cuda")
            want = traverse.traverse_closest_unified(table, orig, dirs, t_min, active, t_max)
            t_any = torch.where(want[0] < 1e19, want[0] * factor, torch.full_like(want[0], 100.0))
            eps = torch.full((R,), EPSILON, device="cuda")
            any_args = (orig, dirs, eps, t_any, active)
            want_any = traverse.traverse_any_unified(table, *any_args)
            out[f"{scene_name}_{kind}"] = {
                "scene": scene_name,
                "closest": tuple(x.cpu() for x in (orig, dirs, t_min, active, t_max)),
                "any": tuple(x.cpu() for x in any_args),
                "want_closest": tuple(x.cpu() for x in want), "want_any": (want_any.cpu(),)}
            print(f"[cases] {scene_name} {kind}: {R} rays, {int(active.sum())} active, "
                  f"{int((want[1] >= 0).sum())} hits, {int(want_any.sum())} occluded", flush=True)
            if kind == "primary":
                orig, dirs, active = cs._bounce_wavefront(torch, flat, orig, dirs, want[0], want[1],
                                                          want[2])
                t_min = torch.full((R,), EPSILON, device="cuda")
        if scene_name == "san_miguel":  # any hit only: the first bounce's two shadow wavefronts
            _, calls = cs._shadow_calls(torch, scene, (flat, meta), cs.MAIN_W, cs.MAIN_H,
                                        use_kernels=False)
            for kind, (o, d, t_max, mask, occ) in zip(("shadow_light", "shadow_bsdf"), calls):
                any_args = (o, d, torch.full_like(t_max, EPSILON), t_max, mask)
                want_any = traverse.traverse_any_unified(table, *any_args)
                assert torch.equal(want_any, occ)
                out[f"{scene_name}_{kind}"] = {"scene": scene_name,
                                               "any": tuple(x.cpu() for x in any_args),
                                               "want_any": (want_any.cpu(),)}
                print(f"[cases] {scene_name} {kind}: {o.shape[0]} rays, {int(mask.sum())} masked "
                      f"in, {int(want_any.sum())} occluded", flush=True)
        del cs._TABLES[uri, 4, 4]
    torch.save({"tables": tables, "cases": out}, path)
    return sorted(out)


class Worker:
    def __init__(self, tree, cases_path):
        self.tree = tree
        self.proc = subprocess.Popen([sys.executable, "-c", WORKER, tree, cases_path], cwd=tree,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ask(self, cmd=None):
        if cmd is not None:
            self.proc.stdin.write(json.dumps(cmd) + "\n")
            self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the worker of {self.tree} ended (exit {self.proc.wait()})")
        return json.loads(line)

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"op": "quit"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of the repository, timed in this order")
    ap.add_argument("--out", required=True, help="JSON file for every median")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    names = [os.path.basename(t.rstrip("/")) for t in trees]
    tmp = tempfile.mkdtemp(prefix="kernel_turns_")
    cases_path = os.path.join(tmp, "cases.pt")
    cases = _cases(torch, cases_path)
    torch.cuda.empty_cache()
    result = {"device": smi, "trees": names, "cases": cases, "rounds": args.rounds,
              "reps": args.reps, "build": {}, "check": {}, "medians": {}}
    workers, live = [], []
    try:
        # a few workers at a time, so that their nvcc builds share the host
        for k in range(0, len(trees), BUILD_AT_ONCE):
            batch = [(n, Worker(t, cases_path))
                     for n, t in zip(names[k:k + BUILD_AT_ONCE], trees[k:k + BUILD_AT_ONCE])]
            workers += [w for _, w in batch]
            for name, w in batch:
                try:
                    ready = w.ask()
                    check = w.ask({"op": "check", "kernels": KERNELS})
                except RuntimeError as e:  # a build or a launch that failed
                    result["build"][name] = {"error": str(e)}
                    print(f"[check] {name}: {e}", flush=True)
                    continue
                result["build"][name] = ready
                result["check"][name] = check
                bad = sorted(k for k, ok in check.items() if not ok)
                print(f"[check] {name}: built in {ready['build_s']:.1f} s; "
                      f"{'bit-equal to plain everywhere' if not bad else 'DIFFERS on ' + ', '.join(bad)}",
                      flush=True)
                if not bad:
                    live.append((name, w))
        order = live + live[::-1]
        for r in range(args.rounds):
            for name, w in order:
                got = w.ask({"op": "time", "kernels": KERNELS, "reps": args.reps})
                for key, ms in got.items():
                    result["medians"].setdefault(name, {}).setdefault(key, []).append(ms)
            print(f"[turns] round {r + 1} of {args.rounds} done", flush=True)
    finally:
        for w in workers:
            w.close()
    summary = {}
    for name, per in result["medians"].items():
        summary[name] = {k: {"mean": statistics.fmean(v), "min": min(v), "max": max(v)}
                         for k, v in per.items()}
    result["summary"] = summary
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for label in KERNELS:
        print(f"[{label}] mean of medians, ms [range], by case:")
        for name in summary:
            cells = [f"{c}: {summary[name][f'{label}@{c}']['mean']:.4f} "
                     f"[{summary[name][f'{label}@{c}']['min']:.4f}-{summary[name][f'{label}@{c}']['max']:.4f}]"
                     for c in cases if f"{label}@{c}" in summary[name]]
            print(f"  {name}: " + "; ".join(cells))
    for name, ready in result["build"].items():
        print(f"[ptxas] {name}: {json.dumps(ready.get('ptxas', ready))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
