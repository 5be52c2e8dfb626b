#!/usr/bin/env python3
"""Time the traversal kernels of several checkouts in turns on one GPU.

    python3 scripts/kernel_turns.py --out chiprun_out/turns.json TREE [TREE ...]

Each TREE is a checkout of this repository (a `git archive` of a commit, or
a copy with its csrc/ edited). The wavefronts are made once, by this
checkout's chip_smoke.py helpers, with the plain walk's results on each:
- two-level tables: sorted primary rays and diffuse-bounce rays at
  1280x720 on the San Miguel proxy, the large San Miguel proxy and a
  576-instance grid, and on the San Miguel proxy also the two masked
  shadow-ray wavefronts (light samples, bsdf samples) of the first bounce
  of one 1-spp 1280x720 frame, captured as chip_smoke.py captures a main
  path's shadow rays (any hit only); kernels B3, B4, B5c, B5d, B6c, B6d;
- flat tables: sorted primary and diffuse-bounce rays on the city
  proc://city?n=610 at 640x360 (its BVH4 table, 10x the L2: B5a, B5b, B1,
  B2, B6a and B6b on the same rays), on the textured hall at 1280x720 on
  its binary table (B7a, B7b, B1, B2, B6a and B6b on the same rays) and on
  its BVH4 table, the one its main path traces (B1, B2, B6a and B6b), and
  on the city and the binary hall the two masked shadow-ray wavefronts of
  the first bounce of one 1-spp frame, captured as on San Miguel (the
  binary hall's over the "packet" route's binary tables; any hit only); on
  the hall's BVH4 table the 5 closest-hit wavefronts of one 1-spp 1280x720
  frame of its main path, captured at B1's launches as chip_smoke.py
  captures them (closest hit only), and all 10 shadow-ray wavefronts of that frame
  (shadow0-shadow9, light and bsdf samples of each bounce in call order;
  any hit only).
--tables picks one of the two sets or both. Then one worker process a tree
builds that tree's kernels and binds them through that tree's own
wrappers, checks every kernel against the plain results, and times them
when asked. The check holds the per-lane kernels bit for bit; B5b and B7b,
which some trees walk as warp packets, must meet the JAX bench's gate
(occlusion mismatches <= max(2, R / 50000)), and whether they are
bit-equal is reported beside it. The trees are
visited in turns, 1-2-...-n-n-...-2-1, for --rounds rounds; each visit
takes the median of --reps CUDA-event timings of every kernel on every
wavefront after a warmup, and the result is the mean of a tree's medians
with their range. A tree that fails its check is reported and not timed.
Any hit runs at t_max = 1.001 x the closest hit on primary rays and 0.999 x
on bounce rays, as chip_smoke.py's bounds do, and on the shadow wavefronts
at their own t_max and mask.

Prints a table and writes every median, each tree's ptxas registers and
spills, and the card's name and power limit to --out.
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
KERNELS = {  # label: (wrapper, closest hit?, the tables it traces)
    "B3": ("traverse_closest_unified", True, ("two_level",)),
    "B5c": ("traverse_closest_unified_stream", True, ("two_level",)),
    "B6c": ("traverse_closest_unified_persistent", True, ("two_level",)),
    "B4": ("traverse_any_unified", False, ("two_level",)),
    "B5d": ("traverse_any_unified_stream", False, ("two_level",)),
    "B6d": ("traverse_any_unified_persistent", False, ("two_level",)),
    "B1": ("traverse_closest", True, ("bvh4", "binary", "hall4")),
    "B2": ("traverse_any", False, ("bvh4", "binary", "hall4")),
    "B6a": ("traverse_closest_persistent", True, ("bvh4", "binary", "hall4")),
    "B6b": ("traverse_any_persistent", False, ("bvh4", "binary", "hall4")),
    "B5a": ("traverse_closest_stream", True, ("bvh4",)),
    "B5b": ("traverse_any_stream", False, ("bvh4",)),
    "B7a": ("traverse_closest_packet", True, ("binary",)),
    "B7b": ("traverse_any_packet", False, ("binary",)),
}
# the kernels held to the JAX bench's gate, not bit for bit: warp packets
# in some tree (bit-equality is reported beside the gate)
GATED = ("B5b", "B7b")
# the table kinds of each --tables choice: two-level tables, the city's
# BVH4 table, the hall's binary and BVH4 tables
TABLE_SETS = {"two_level": ("two_level",), "flat": ("bvh4", "binary", "hall4"),
              "all": ("two_level", "bvh4", "binary", "hall4")}

# One tree's worker: builds and binds the tree's kernels, then answers one
# JSON command a line on stdin with one JSON line on stdout.
WORKER = r"""
import json, os, sys, time
tree, cases_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
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
ptxas = {"@".join(map(str, k)): v for k, v in ptxas.items()}
saved = torch.load(cases_path)
tables = {}
for k, t in saved["tables"].items():
    fields = {f: v.cuda() if torch.is_tensor(v) else v for f, v in t["fields"].items()}
    tables[k] = (UnifiedBvh if t["kind"] == "two_level" else PackedBvh)(**fields), t["kind"]
cases = {}
for name, c in saved["cases"].items():
    table, kind = tables[c["scene"]]
    cases[name] = (kind, {hit: ((table,) + tuple(x.cuda() for x in c[hit]),
                                tuple(x.cuda() for x in c["want_" + hit]))
                          for hit in ("closest", "any") if hit in c})
del saved

def calls(kernels):
    for label, (wrapper, closest, kinds) in kernels.items():
        fn = getattr(traverse_cuda, wrapper)
        hit = "closest" if closest else "any"
        for name, (kind, c) in cases.items():
            if kind in kinds and hit in c:
                yield f"{label}@{name}", fn, closest, kind, c[hit]

reply({"ready": True, "build_s": build_s, "ptxas": ptxas})
for line in sys.stdin:
    cmd = json.loads(line)
    if cmd["op"] == "check":
        out = {}
        for key, fn, closest, kind, (args, want) in calls(cmd["kernels"]):
            got = fn(*args)
            got = got if closest else (got,)
            torch.cuda.synchronize()
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            agree = (chip_smoke._closest_agreement(got, want, kind == "two_level") if closest
                     else chip_smoke._any_agreement(got[0], want[0]))
            out[key] = {"exact": exact, "gate": agree["ok"],
                        "mismatch": agree.get("prim_mismatch", agree.get("occ_mismatch"))}
        reply(out)
    elif cmd["op"] == "time":
        out = {}
        for key, fn, _, _, (args, _) in calls(cmd["kernels"]):
            out[key] = chip_smoke._median_ms(torch, lambda: fn(*args), cmd["reps"])
        reply(out)
    else:
        break
"""


def _save_table(torch, tables, name, kind, table):
    tables[name] = {"kind": kind, "fields": {k: v.cpu() if torch.is_tensor(v) else int(v)
                                             for k, v in table._asdict().items()}}


def _closest_and_any(torch, out, scene_name, table, closest, any_, orig, dirs, t_min, active, kind,
                     factor):
    """One wavefront's case: the plain closest hit, then the plain any hit at
    t_max = factor x that hit (100 on a miss). Returns the plain closest
    result."""
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.math import EPSILON

    R = orig.shape[0]
    t_max = torch.full((R,), T_MAX, device="cuda")
    want = closest(table, orig, dirs, t_min, active, t_max)
    t_any = torch.where(want[0] < 1e19, want[0] * factor, torch.full_like(want[0], 100.0))
    any_args = (orig, dirs, torch.full((R,), EPSILON, device="cuda"), t_any, active)
    want_any = any_(table, *any_args)
    out[f"{scene_name}_{kind}"] = {
        "scene": scene_name,
        "closest": tuple(x.cpu() for x in (orig, dirs, t_min, active, t_max)),
        "any": tuple(x.cpu() for x in any_args),
        "want_closest": tuple(x.cpu() for x in want), "want_any": (want_any.cpu(),)}
    print(f"[cases] {scene_name} {kind}: {R} rays, {int(active.sum())} active, "
          f"{int((want[1] >= 0).sum())} hits, {int(want_any.sum())} occluded", flush=True)
    return want


def _cases(torch, path, kinds):
    """Make the wavefronts of the table kinds asked for and the plain
    results, and save them (on the CPU) at path: {"tables": {scene:
    {"kind", "fields"}}, "cases": {case: {"scene", "closest", "any",
    "want_closest", "want_any"}}}."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from chameleonrt_tpu_torch.ops import traverse
    from chameleonrt_tpu_torch.ops.math import EPSILON

    tables, out = {}, {}
    scenes = []
    if "two_level" in kinds:
        scenes += [("san_miguel", cs.SAN_MIGUEL, "two_level", cs.MAIN_W, cs.MAIN_H),
                   ("large_proxy", cs.SAN_MIGUEL_LARGE, "two_level", cs.MAIN_W, cs.MAIN_H),
                   ("grid576", GRID_576, "two_level", cs.MAIN_W, cs.MAIN_H)]
    if "bvh4" in kinds:
        scenes.append(("city", cs.CITY_SCENE, "bvh4", cs.CITY_W, cs.CITY_H))
    if "binary" in kinds:
        scenes.append(("hall", cs.HALL_SCENE, "binary", cs.MAIN_W, cs.MAIN_H))
    if "hall4" in kinds:
        scenes.append(("hall4", cs.HALL_SCENE, "hall4", cs.MAIN_W, cs.MAIN_H))
    for k, (scene_name, uri, kind, W, H) in enumerate(scenes):
        scene, flat, meta = cs._scene_tables(torch, uri)
        two_level = kind == "two_level"
        table = flat.blas[0].closest if kind == "binary" else flat.blas[0].any
        closest = traverse.traverse_closest_unified if two_level else traverse.traverse_closest
        any_ = traverse.traverse_any_unified if two_level else traverse.traverse_any
        _save_table(torch, tables, scene_name, kind, table)
        orig, dirs, active = cs._primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        want = _closest_and_any(torch, out, scene_name, table, closest, any_, orig, dirs,
                                torch.zeros((R,), device="cuda"), active, "primary", 1.001)
        orig, dirs, active = cs._bounce_wavefront(torch, flat, orig, dirs, want[0], want[1],
                                                  want[2] if two_level else None)
        _closest_and_any(torch, out, scene_name, table, closest, any_, orig, dirs,
                         torch.full((R,), EPSILON, device="cuda"), active, "bounce", 0.999)
        if kind == "hall4":
            # closest hit only: the main path's frame, captured at B1's launches
            for n, (t, args, _) in enumerate(cs._closest_frame_calls(torch, scene, (flat, meta),
                                                                     "flat", W, H)):
                assert t is table
                want = closest(table, *args)
                out[f"{scene_name}_frame{n}"] = {"scene": scene_name,
                                                 "closest": tuple(x.cpu() for x in args),
                                                 "want_closest": tuple(x.cpu() for x in want)}
                print(f"[cases] {scene_name} frame{n}: {args[0].shape[0]} rays, "
                      f"{int(args[3].sum())} active, {int((want[1] >= 0).sum())} hits", flush=True)
        if scene_name in ("san_miguel", "city", "hall", "hall4"):
            # any hit only: the first bounce's two shadow wavefronts, and on
            # the hall's BVH4 table all 10 of the frame, its main path's
            # the plain walk; the binary hall's over both of the "packet" route's binary
            # tables (CHAMELEONRT_PACKET=0 keeps that route's tables and turns its kernels off)
            binary = kind == "binary"
            with cs._env(**({"CHAMELEONRT_PACKET": "0"} if binary else {})):
                _, calls = cs._shadow_calls(torch, scene, (flat, meta), W, H,
                                            traversal="packet" if binary else "plain")
            shadows = ([f"shadow{n}" for n in range(len(calls))] if kind == "hall4"
                       else ["shadow_light", "shadow_bsdf"])
            for shadow, (o, d, t_max, mask, occ) in zip(shadows, calls):
                any_args = (o, d, torch.full_like(t_max, EPSILON), t_max, mask)
                want_any = any_(table, *any_args)
                assert torch.equal(want_any, occ)
                out[f"{scene_name}_{shadow}"] = {"scene": scene_name,
                                                 "any": tuple(x.cpu() for x in any_args),
                                                 "want_any": (want_any.cpu(),)}
                print(f"[cases] {scene_name} {shadow}: {o.shape[0]} rays, {int(mask.sum())} "
                      f"masked in, {int(want_any.sum())} occluded", flush=True)
        if all(later[1] != uri for later in scenes[k + 1:]):
            del cs._TABLES[uri, 4, 4]
        del scene, flat, meta, table
        torch.cuda.empty_cache()
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
    ap.add_argument("--tables", choices=sorted(TABLE_SETS), default="all",
                    help="the wavefronts: two-level tables, flat tables, or both")
    args = ap.parse_args()
    kinds = TABLE_SETS[args.tables]
    kernels = {label: k for label, k in KERNELS.items() if set(k[2]) & set(kinds)}
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
    cases = _cases(torch, cases_path, kinds)
    torch.cuda.empty_cache()
    result = {"device": smi, "trees": names, "tables": args.tables, "cases": cases, "rounds": args.rounds,
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
                    check = w.ask({"op": "check", "kernels": kernels})
                except RuntimeError as e:  # a build or a launch that failed
                    result["build"][name] = {"error": str(e)}
                    print(f"[check] {name}: {e}", flush=True)
                    continue
                result["build"][name] = ready
                result["check"][name] = check
                bad = sorted(k for k, c in check.items()
                             if not (c["gate"] if k.split("@")[0] in GATED else c["exact"]))
                gated = sorted(k for k, c in check.items() if not c["exact"])
                print(f"[check] {name}: built in {ready['build_s']:.1f} s; "
                      f"{'passes' if not bad else 'FAILS on ' + ', '.join(bad)}; "
                      f"bit-equal to plain {'everywhere' if not gated else 'except ' + ', '.join(gated)}"
                      f" ({json.dumps({k: c['mismatch'] for k, c in check.items() if not c['exact']})})",
                      flush=True)
                if not bad:
                    live.append((name, w))
        order = live + live[::-1]
        for r in range(args.rounds):
            for name, w in order:
                got = w.ask({"op": "time", "kernels": kernels, "reps": args.reps})
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
    for label in kernels:
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
