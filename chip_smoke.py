#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
CUDA card, nvcc, g++ and the repository's sources, and imports neither JAX
nor the JAX package (it asserts so at its end). Phases:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch, CUDA and nvcc versions;
2. build: the kernels (csrc/*.cu, one nvcc each, in parallel), with
   ptxas's registers and spills for each traversal kernel, arity and stack
   capacity (every kernel at 64 and 128 entries); then S1, the shading
   kernel (csrc/shade.cu), against the plain shading on the live lanes of
   a 2880x2880 Cornell frame at bounces 0 and 3, bit for bit, timed beside
   the plain version and its bytes bound (phase_shade), and on every main
   path launched 5 times a frame a sample; then R1-R3, the re-sort's
   kernels (csrc/sort.cu), with the int32 stable sort against the plain
   re-sort on the wavefronts of a 2880x2880 Cornell frame before bounces 0
   and 2: bounds, keys, permutation and the seven fields equal on every
   lane, each kernel and the sort timed beside its bytes bound, the plain
   re-sort and torch.argsort of the int64 key beside them (phase_sort);
   on every main path launched 3 times a bounce;
3. kernels against their plain torch versions on the card, each with
   kernel and plain times on a sorted primary wavefront and a
   diffuse-bounce wavefront from its hit points:
   - B1/B2 (flat) on proc://hall?subdiv=2 at 320x180 and on the textured
     hall at 1280x720 (B3's closest and B4's any walk over a flat table,
     held exactly, as B5a/B5b), B2, exactly, on the 10 masked shadow-ray
     wavefronts of one 1280x720 hall frame, and B1, exactly, on the 5
     closest-hit wavefronts of one, each timed beside its bound;
   - B3/B4 (two-level) on proc://instances?nx=4&ny=4&subdiv=2 at 320x180
     and on the San Miguel proxy at 1280x720, and B4 on the 10 masked
     shadow-ray wavefronts of one 1-spp San Miguel frame at 1280x720, each
     timed beside its bound there;
   - B5a/B5b (the streamed tier, whose plain versions are B1/B2's; per-lane
     walks held exactly, 0 mismatches and |dt| = |du| = |dv| = 0) on
     proc://city?n=60 at 320x180, forced, and on the 6.7M-triangle
     proc://city?n=610 at 640x360, which the gate must route to them, any
     hit at both t_max factors on both wavefronts, with B1/B2 timed on the
     same rays; B5b, exactly, on the 10 masked shadow-ray wavefronts of one
     640x360 city frame, beside B2, and B5a, exactly, on the 5 closest-hit
     wavefronts of one, beside B1, each timed on the same rays and beside
     its bound;
   - B5c/B5d (the two-level streamed tier, per-lane walks bit-equal to
     their plain versions, B3/B4's: 0 mismatches and |dt| = |du| = |dv|
     = 0, the gate of every two-level kernel) on
     proc://instances?nx=4&ny=4&subdiv=2 at 320x180, forced, and on the
     large San Miguel proxy (gen://san_miguel?leaf_tris=700000
     &canopy_instances=10: 95 instances, 9.67M instanced triangles, a
     two-level table about three times the L2) at 1280x720, which the gate
     must route to them, any hit at both t_max factors on both wavefronts,
     with B3/B4 timed on the same rays; and B5d on the 10 masked
     shadow-ray wavefronts of one 1-spp 1280x720 frame of it, each timed
     beside its bound there;
   - B6a-B6d (the work-queue kernels that trace every scene with the
     slot-lane tier off, whose plain versions are B1-B4's) on every
     wavefront above: B6a/B6b on the flat and city wavefronts, B6c/B6d on
     the two-level ones, each against the plain result already computed
     for the tier's kernel on the same rays and timed beside it, with its
     outputs (and its queue's counter) allocated as sentinels that must
     not survive, and again on the first 777 rays alone (far fewer than
     the grid's threads, not a multiple of 32); B6b / B6d on the
     shadow-ray wavefronts of one hall / San Miguel frame (B6d timed on
     each beside its bound, and logged whether that frame's rays digest
     as those of B4's frame); and B6a, exactly, on the 5 closest-hit
     wavefronts of one slotlane=False hall frame, beside B1 and its bound;
   - B7a/B7b (the grid-packet kernels, binary rows only, whose plain
     versions are B1/B2's on the same binary table; per-lane walks held
     exactly) on the hall's binary table: proc://hall?subdiv=2 at 320x180
     and the textured hall at 1280x720, any hit at both t_max factors on
     both wavefronts, with B1/B2 timed on the same rays on the binary table
     and on the BVH4 table; B7b, exactly, on the 10 masked shadow-ray
     wavefronts of one 1280x720 hall frame with grid_packet=True, beside B2
     on the binary table, and B7a, exactly, on the 5 closest-hit wavefronts
     of one, as B5a;
   - B1-B6d at every arity they take (2, 4 and 8 children a row) on the
     primary wavefronts of the parity scenes at 320x180: B1/B2 and B6a/B6b
     on proc://hall?subdiv=2, B5a/B5b (forced) on proc://city?n=60, B3/B4,
     B5c/B5d (forced) and B6c/B6d on proc://instances?nx=4&ny=4&subdiv=2,
     and the two-level kernels again on a 576-instance grid at leaf sizes
     5 and 9, whose leaf rows are read slot by slot and whose entry rows
     start 8 bytes past 16 at every other row, each against the plain
     version on the same table;
   - C3 (phase_bvh8): the stack each main-path scene's BVH8 table needs
     (CHAMELEONRT_WIDE_ARITY=8; all but the hall's exceed 64), and on those
     tables B3/B4 and B6c/B6d (San Miguel), B5c/B5d (the large proxy) and
     B5a/B5b (the city) against the plain walk on the main-path primary
     wavefront (B3-B7b exactly), with the stack capacity each launch ran
     with (128), and a
     BVH8 San Miguel image against the plain walk;
   each kernel's least time on its main-path primary and bounce wavefronts
   (bound_ms, bounce_bound_ms) comes from the distinct rows and the
   operations that wavefront's rays need, counted by the plain walk
   (ops/traverse.py WalkCount); B6a-B6d compute the same functions on the
   same rays as B1-B4 and share their bounds; on the main-path wavefronts
   each kernel is also timed at its 128-entry instantiation
   (ms_stack128), whose result must equal the 64-entry one's; every
   any-hit kernel is timed on its main-path frame's 10 shadow wavefronts
   beside its bound there;
4. images through the kernels against images through the plain traversal
   (textured hall, proc://instances?nx=6&ny=6&subdiv=3, with stream=True
   proc://city?n=60 and proc://instances?nx=6&ny=6&subdiv=3, with
   slotlane=False the textured hall and proc://instances?nx=6&ny=6&subdiv=3,
   with grid_packet=True the textured hall, and the textured hall and
   proc://instances?nx=6&ny=6&subdiv=3 under each of the table switches
   CHAMELEONRT_CLOSEST_ARITY=2, CHAMELEONRT_WIDE_ARITY=8 and
   CHAMELEONRT_LEAF_SIZE=8; 128x72, 2 frames each): 8-bit mean abs
   difference < 1;
4b. the brute-force `reference` backend (phase_reference): the JAX
   bench's image gate, get_backend("cuda") against get_backend("reference")
   on the textured hall and on proc://instances?nx=6&ny=6&subdiv=3 at
   128x72, 1 spp, 8-bit MAD < 1; the oracle (ops/intersect.py
   brute_force_closest / brute_force_any through
   engine/trace_bruteforce.py) against B1 and B2 on the main path's
   textured hall (224,768 triangles) on a sorted 320x180 primary wavefront
   and its diffuse-bounce wavefront (closest hit, and any hit to 1.001 of
   the hit on even lanes and to 0.999 on odd lanes, so that B2 must both
   find the hit and stop at t_max), held to the JAX bench's gate, with the
   oracle's seconds and peak memory; and the reference backend's ms per
   frame at 128x72;
4c. the command line (phase_cli), each run in a process of its own:
   `python -m chameleonrt_tpu_torch.cli cuda proc://cornell -img 256 256
   -spp 2 -frames 3` with -validation and -checkpoint, the same resumed
   from that checkpoint for 2 frames under -profile (the frame count goes
   on; the trace names B1 and B2), and, beside these two, the reference
   backend with -benchmark-frames 2 at 64x64;
4d. the LBVH fallback (phase_lbvh), what a host with no C++ compiler
   runs: the LBVH (chameleonrt_tpu_torch/ops/lbvh.py) of the main path's
   hall and of proc://instances?nx=4&ny=4&subdiv=2 built on the card and
   timed; on the hall's sorted 1280x720 primary wavefront, B1/B2 over
   its LBVH against the plain walk over it, exactly, and against B1/B2
   over its native table on the JAX bench's gate, with lanes at -2
   logged; get_backend("cuda") with native.get_lib patched to None on the
   textured hall and that grid at 128x72, its launch counts read (B1/B2,
   one launch each an instance of the grid, 64-entry stacks); and
   `python -m chameleonrt_tpu_torch.cli cuda` on the same two scenes in
   processes whose CXX names no compiler (so that native.get_lib() is
   None: LBVH tables, traced by B1/B2), each image against the native
   builder's, 8-bit MAD < 1;
4e. the port's bench (phase_bench): `python3 -m
   chameleonrt_tpu_torch.bench` in a process of its own, which must exit
   0 with bench.py's JSON line as its last, its parity gate passed and all
   six configs measured (Mray/s > 0); the line is logged;
5. the main paths, each with the kernels' launch counts set to 0 just
   before it and read just after: get_backend("cuda") rendering
   proc://hall?subdiv=4&textured=1 at 1280x720, 1 spp (B1/B2), the San
   Miguel proxy (gen://san_miguel: 155 instances, 9.67M instanced
   triangles, generated as bench.py does) at 1280x720, 4 spp (B3/B4), the
   city proc://city?n=610 at 640x360, 1 spp (B5a/B5b), the large San
   Miguel proxy at 1280x720, 4 spp (B5c/B5d), and with
   get_backend("cuda", slotlane=False) the hall (B6a/B6b) and the San
   Miguel proxy (B6c/B6d) at the same sizes, and with
   get_backend("cuda", grid_packet=True) the hall on its binary table
   (B7a/B7b) at 1280x720, 1 spp, and after them, as paths of their own
   (_bench_paths), the three bench configs that no main path runs, at
   the bench's sizes and 1 spp: proc://cornell at
   512x512 (B1/B2), proc://instances?nx=6&ny=6&subdiv=3 at 1280x720
   (B3/B4) and the 6.7M-triangle soup
   proc://random?n_tris=6700000&spread=12 at 640x360, whose table exceeds
   the L2 (B5a/B5b); each path's last frame runs
   under torch.profiler, which gives where its time goes: device busy
   time, the idle share of the frame, and the device time of the traversal
   kernels and of the largest other rows, and its table (rows, bytes,
   certified stack) is logged; every launch of these main paths (BVH4
   tables, and the hall's binary one) must have run with the 64-entry
   stack;
6. multi-device rendering (phase_sharded; parallel/sharded.py), N shards
   on cuda:0 through get_backend("cuda", devices=[cuda:0] * N): the
   textured hall with 4 and with 7 shards (B1/B2) and the bench's
   36-instance grid with 4 (B3/B4) at 1280x720, 1 spp, 2 frames, each
   static and with rebalance=True beside one device: sRGB8 images equal
   to one device's, accumulators within 1e-5, equal rays, 5 + 10 launches
   a shard a frame (counts set to 0 just before each run and read just
   after), lanes moved in every rebalanced frame; and `python -m
   chameleonrt_tpu_torch.cli cuda proc://cornell -devices all -rebalance`
   writes the image of the same run without the flags.

A gen://san_miguel URI is this script's own: _load generates the scene
with the port's scene/pbrt_gen.py (its query string gives the generator's
arguments) into the build directory and loads it through the port's PBRT
loader. Scenes are loaded once per URI.

Every phase raises on failure and the script then exits nonzero. The line
before the last is a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HALL_SCENE = "proc://hall?subdiv=4&textured=1"
HALL_PARITY = "proc://hall?subdiv=2"
HALL_IMAGE = "proc://hall?subdiv=1&textured=1&columns=4"
INST_PARITY = "proc://instances?nx=4&ny=4&subdiv=2"
INST_IMAGE = "proc://instances?nx=6&ny=6&subdiv=3"
SAN_MIGUEL = "gen://san_miguel"
# the two-level streamed tier (B5c/B5d): a San Miguel proxy with larger
# foliage meshes (2.17M unique, 9.67M instanced triangles) whose two-level
# table exceeds the L2; the parity grid fits and is forced onto it
SAN_MIGUEL_LARGE = "gen://san_miguel?leaf_tris=700000&canopy_instances=10"
# the streamed tier (B5a/B5b): the Rungholt-class city (6.7M tris,
# bench.py's rungholt_city at its 640x360, 1 spp) takes it by the gate; the
# small city (65K tris) fits the L2 and is forced onto it
CITY_SCENE = "proc://city?n=610"
CITY_PARITY = "proc://city?n=60"
MAIN_W, MAIN_H = 1280, 720
CITY_W, CITY_H = 640, 360
HALL_TIMED_FRAMES = 4
SM_SPP = 4
SM_TIMED_FRAMES = 4
CITY_TIMED_FRAMES = 3
LARGE_TIMED_FRAMES = 3
# the three bench configs that no main path runs (the port's bench.py
# CONFIGS: cornell, instanced, rungholt_soup), driven after the main paths
# at their sizes (_bench_paths)
BENCH_PATHS = {"cornell": "cornell", "instanced": "instanced", "soup": "rungholt_soup"}
BENCH_PATH_TIMED_FRAMES = 2
SHARDED_FRAMES = 2  # phase_sharded's progressive frames a run
PROFILE_FRAMES = 1
# python -m chameleonrt_tpu_torch.bench in its own process (phase_bench)
BENCH_TIMEOUT_S = 900
# the LBVH fallback (phase_lbvh): builds timed after one warmup, and a
# compiler name that no PATH holds, so that native.get_lib() is None
LBVH_BUILD_REPS = 3
NO_COMPILER = "crt-no-such-c++-compiler"
# the JAX bench's image gate (bench.py:174-190) and parity wavefront size
# (bench.py:49), at which the brute-force oracle checks B1 and B2
GATE_W, GATE_H = 128, 72
ORACLE_W, ORACLE_H = 320, 180
REFERENCE_FRAMES = 3
# traversal gates (the JAX bench's parity gates): prim (and instance) /
# occlusion mismatches <= max(2, R / 50000), |dt| over common hits and
# |du|, |dv| over hits on the same triangle <= 1e-5
DT_TOL = 1e-5
UV_TOL = 1e-5
# timings: median of this many CUDA-event timed calls after one warmup (for
# the plain version, the parity call just before is the warmup); the plain
# walks over the San Miguel proxies and the city take ~0.4-1.9 s a call, so
# they get one
KERNEL_REPS = 5
PLAIN_REPS = 5
PLAIN_REPS_SAN_MIGUEL = 3
PLAIN_REPS_CITY = 3
PLAIN_REPS_LARGE = 1
PLAIN_REPS_PACKET = 3
# a kernel's least time (bound_ms): the larger of the bytes it must move
# over the card's memory rate and its FP32 operations over the card's rate
# outside the tensor cores (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of the kernels' arithmetic (csrc/traverse_common.cuh):
# the slab test of one child box (6 subtractions, 6 products, 12 min/max,
# 1 compare), Moller-Trumbore on one slot (two cross products 18, four dot
# products and the scalings by 1/det 23, 3 subtractions, 1 division, an
# abs and a compare 2, the range tests and u + v 6), the instance-entry
# transform (33 products and sums, 3 reciprocals) and a ray's 3
# reciprocals
SLAB_OPS = 25
MT_OPS = 53
ENTRY_OPS = 36
RAY_OPS = 3
# bytes per ray: in orig, dir, t_min, t_max, the mask; out t, prim, u, v
# (closest hit, plus inst on a two-level table) or the occluded flag
RAY_IN_BYTES = 12 + 12 + 4 + 4 + 1
# the work-queue kernels' small wavefront: far fewer rays than their grids
# hold (at least 5 resident blocks of 128 threads on each of 132 SMs) and
# not a multiple of 32, so the queue's empty and ragged ends run
SMALL_R = 777
# what _sentinel_outputs fills fresh outputs with: NaN (floats), this
# (integers: no prim or instance reaches it, and a queue counter left there
# hands out no ray) and this byte (bool flags)
INT_SENTINEL = 1 << 30
BOOL_SENTINEL = 0xA5


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_toolchain(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, python {sys.version.split()[0]}")
    from chameleonrt_tpu_torch import _build

    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    log(f"[device] nvcc: {nvcc[-1] if nvcc else '?'}")
    return smi


# a kernel instantiation in ptxas's log: its launch-count key and its
# template arguments, the node rows' arity and the stack capacity, or the
# capacity alone (B7a, B7b: binary rows only), or neither (S1, R1-R3)
# (_ZN12_GLOBAL__N_114closest_kernelILi8ELi64EEEv...,
# ..._packet_kernelILi64EEvPKf..., ..._packet_kernelEPKf...,
# ..._shade_cu_77d03ee319shade_bounce_kernelEN3crt5shade5SceneE...)
_PTXAS_KERNEL = re.compile(
    r"(?<![a-z_])((?:closest|any)(?:_unified)?(?:_stream|_persistent|_packet)?|shade_bounce"
    r"|sort_(?:bounds|key|gather))_kernel"
    r"(?:ILi(\d+)E(?:Li(\d+)E)?)?")


def _ptxas_table(log_text):
    """{(launch-count key, arity or None, stack capacity or None):
    {"registers", "spill_stores", "spill_loads", "stack_frame"}} from
    nvcc's ptxas -v output; B7a's instantiations are at arity 2, S1's
    one kernel is ("shade_bounce", None, None)."""
    out, key = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = _PTXAS_KERNEL.search(m.group(1))
            key = None
            if k:
                nums = [int(g) for g in k.groups()[1:] if g]
                arity = next((n for n in nums if n <= 8), 2 if nums else None)
                key = (k.group(1), arity, next((n for n in nums if n > 8), None))
                out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[key].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Build and load the kernels. Returns (seconds, _ptxas_table)."""
    from chameleonrt_tpu_torch import _build

    t0 = time.perf_counter()
    _build.kernels()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {secs:.2f} s")
    with open(_build.kernel_library_path()[: -len(".so")] + ".log") as f:
        text = f.read()
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")
    ptxas = _ptxas_table(text)
    log(f"[build] per kernel, arity and stack capacity: "
        f"{json.dumps({'@'.join(map(str, k)): v for k, v in sorted(ptxas.items(), key=str)})}")
    return secs, ptxas


# S1 (csrc/shade.cu) on the live lanes of one 1-spp Cornell Box frame at
# these bounces and this size
SHADE_SCENE = "proc://cornell"
SHADE_SIZE = 2880
SHADE_BOUNCES = (0, 3)
SHADE_REPS = 9
SHADE_PLAIN_REPS = 3
# the bytes S1 reads a lane (state, dir, throughput, active, hit_p, hit_tri,
# hit_u, hit_v; hit_inst too where the scene has instances) and writes
# (ShadeOut's 12 fields)
SHADE_IN_BYTES = 8 + 12 + 12 + 1 + 12 + 4 + 4 + 4
SHADE_INST_BYTES = 4
SHADE_OUT_BYTES = 8 + 12 + 12 + 1 + 12 + 4 + 1 + 12 + 4 + 12 + 12 + 1


def phase_shade(torch):
    """S1 (csrc/shade.cu) against the plain shading, _shade_bounce, on the
    live lanes of one SHADE_SIZE x SHADE_SIZE 1-spp frame of the Cornell Box
    at each of SHADE_BOUNCES (captured at ops/shade_cuda.shade_bounce):
    every field bit-equal on every lane (NaN where both are NaN), since
    both sides round alike; S1's time (median of SHADE_REPS CUDA-event
    timings) beside the plain version's and beside its bound, the bytes it
    moves (SHADE_IN_BYTES, SHADE_INST_BYTES where the scene has instances,
    and SHADE_OUT_BYTES a lane) at HBM_BYTES_PER_S. Returns the record."""
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.engine import path_tracer
    from chameleonrt_tpu_torch.ops import shade_cuda

    scene = _load(SHADE_SCENE)
    backend = get_backend("cuda")
    backend.initialize(SHADE_SIZE, SHADE_SIZE)
    backend.set_scene(scene)
    shade = shade_cuda.shade_bounce
    calls = {}

    def capture(flat, meta, bounce, *lanes):
        if bounce in SHADE_BOUNCES:
            calls[bounce] = (flat, meta, tuple(x.clone() for x in lanes))
        return shade(flat, meta, bounce, *lanes)

    shade_cuda.shade_bounce = capture
    try:
        backend.render(*_view(scene), True, readback_framebuffer=False)
    finally:
        shade_cuda.shade_bounce = shade
    res = {"scene": SHADE_SCENE, "width": SHADE_SIZE, "height": SHADE_SIZE}
    for bounce, (flat, meta, lanes) in sorted(calls.items()):
        R = lanes[0].shape[0]
        got = shade(flat, meta, bounce, *lanes)
        want = path_tracer._shade_bounce(flat, meta, bounce, *lanes)
        torch.cuda.synchronize()
        differ = {}
        for field in want._fields:
            a, w = getattr(got, field).reshape(R, -1), getattr(want, field).reshape(R, -1)
            bad = (a != w) & ~(a.isnan() & w.isnan()) if a.is_floating_point() else a != w
            differ[field] = int(bad.any(1).sum())
        if any(differ.values()):
            raise AssertionError(f"S1 at bounce {bounce}: lanes that differ from the plain "
                                 f"shading {differ}")
        ms = _median_ms(torch, lambda: shade(flat, meta, bounce, *lanes), SHADE_REPS)
        plain_ms = _median_ms(torch, lambda: path_tracer._shade_bounce(flat, meta, bounce, *lanes),
                              SHADE_PLAIN_REPS)
        lane_bytes = (SHADE_IN_BYTES + SHADE_OUT_BYTES
                      + (SHADE_INST_BYTES if meta.num_instances > 1 else 0))
        n_bytes = R * lane_bytes
        res[f"bounce{bounce}"] = {"lanes": R, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": n_bytes,
                                  "lane_bytes": lane_bytes}
    del backend, calls
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[shade] {json.dumps(res)}")
    return res


# R1-R3 (csrc/sort.cu) around the int32 stable sort, on the re-sorts of one
# 1-spp Cornell Box frame at this size, before these bounces
SORT_SCENE = "proc://cornell"
SORT_SIZE = 2880
SORT_BOUNCES = (0, 2)
SORT_REPS = 9
SORT_PLAIN_REPS = 5
# the bytes a lane each step moves at least: R1 reads orig; R2 reads orig,
# dir and active and writes the int32 key; the radix sort reads and writes
# the key and an int64 index in each of its 4 passes; R3 reads the
# permutation and the seven fields (state 8, orig, dir, throughput and
# illum 12 each, active 1, lane_pixel 8) and writes the fields
SORT_FIELD_BYTES = 8 + 4 * 12 + 1 + 8
SORT_LANE_BYTES = {"R1": 12, "R2": 12 + 12 + 1 + 4, "sort": 4 * 2 * (4 + 8),
                   "R3": 8 + 2 * SORT_FIELD_BYTES}


def _sort_differ(torch, wave):
    """Lanes where the kernel path differs from the plain path on one CUDA
    wavefront: R1's bounds against torch's min and max (NaN where it is),
    R2's key against ray_sort_key, the stable sort's permutation against
    ray_sort_perm_only, and each of the seven sorted fields bit for bit.
    Returns {what: lanes (or bounds) that differ}."""
    from chameleonrt_tpu_torch.ops import sort_cuda
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_key, ray_sort_perm_only

    orig, dir, active = wave[1], wave[2], wave[5]
    R = orig.shape[0]
    lohi = sort_cuda.bounds(orig)
    want = torch.cat([orig.min(0).values, orig.max(0).values])
    key = sort_cuda.keys(orig, dir, active, lohi)
    perm = torch.sort(key, stable=True).indices
    got = sort_cuda.sort_wavefront(*wave)
    plain = sort_cuda.sort_wavefront_plain(*wave)
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    differ = {"bounds": int((~((lohi == want) | (lohi.isnan() & want.isnan()))).sum()),
              "key": int((key.long() != ray_sort_key(orig, dir, active)).sum()),
              "perm": int((perm != ray_sort_perm_only(orig, dir, active)).sum())}
    for (name, _, _), g, w in zip(sort_cuda.FIELDS, got, plain):
        differ[name] = int((bits(g) != bits(w)).reshape(R, -1).any(1).sum())
    return differ


def phase_sort(torch):
    """R1-R3 (csrc/sort.cu) and the int32 stable sort against the plain
    re-sort (sort_wavefront_plain: ray_sort_perm_only's int64 key, its
    argsort and seven gathers) on the wavefronts of one SORT_SIZE x
    SORT_SIZE 1-spp frame of the Cornell Box before each of SORT_BOUNCES
    (captured at ops/sort_cuda.sort_wavefront): bounds, keys, permutation
    and every field equal on every lane (_sort_differ). Times (median of
    SORT_REPS CUDA-event timings): each kernel and the sort beside its
    bytes bound (SORT_LANE_BYTES at HBM_BYTES_PER_S), the whole kernel
    path, the plain re-sort, and torch.argsort of the int64 key, the
    yardstick the kernel path's sort replaces. Returns the record."""
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.ops import sort_cuda
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_key

    scene = _load(SORT_SCENE)
    backend = get_backend("cuda")
    backend.initialize(SORT_SIZE, SORT_SIZE)
    backend.set_scene(scene)
    sort = sort_cuda.sort_wavefront
    calls, seen = {}, [0]

    def capture(*wave):
        if seen[0] in SORT_BOUNCES:
            calls[seen[0]] = tuple(x.clone() for x in wave)
        seen[0] += 1
        return sort(*wave)

    sort_cuda.sort_wavefront = capture
    try:
        backend.render(*_view(scene), True, readback_framebuffer=False)
    finally:
        sort_cuda.sort_wavefront = sort
    res = {"scene": SORT_SCENE, "width": SORT_SIZE, "height": SORT_SIZE,
           "lane_bytes": SORT_LANE_BYTES}
    for bounce, wave in sorted(calls.items()):
        R = wave[0].shape[0]
        differ = _sort_differ(torch, wave)
        if any(differ.values()):
            raise AssertionError(f"the re-sort before bounce {bounce}: lanes that differ from "
                                 f"the plain re-sort {differ}")
        orig, dir, active = wave[1], wave[2], wave[5]
        lohi = sort_cuda.bounds(orig)
        key = sort_cuda.keys(orig, dir, active, lohi)
        perm = torch.sort(key, stable=True).indices
        key64 = ray_sort_key(orig, dir, active)
        ms = {"R1": _median_ms(torch, lambda: sort_cuda.bounds(orig), SORT_REPS),
              "R2": _median_ms(torch, lambda: sort_cuda.keys(orig, dir, active, lohi), SORT_REPS),
              "sort": _median_ms(torch, lambda: torch.sort(key, stable=True), SORT_REPS),
              "R3": _median_ms(torch, lambda: sort_cuda.gather(perm, wave), SORT_REPS)}
        bound = {k: R * b / HBM_BYTES_PER_S * 1e3 for k, b in SORT_LANE_BYTES.items()}
        res[f"bounce{bounce}"] = {
            "lanes": R, "live": int(active.sum()), "ms": ms, "bound_ms": bound,
            "kernel_path_ms": _median_ms(torch, lambda: sort(*wave), SORT_REPS),
            "kernel_path_bound_ms": sum(bound.values()),
            "plain_ms": _median_ms(torch, lambda: sort_cuda.sort_wavefront_plain(*wave),
                                   SORT_PLAIN_REPS),
            "library_ms": _median_ms(torch, lambda: torch.argsort(key64, stable=True), SORT_REPS),
        }
    del backend, calls
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sort] {json.dumps(res)}")
    return res


_SCENES = {}
_TABLES = {}


def _load(uri):
    """The scene at uri, loaded once per URI. A gen://san_miguel URI is
    generated first with the port's generate_san_miguel_proxy, as bench.py
    does, into the build directory; its query string (integers) gives the
    generator's arguments."""
    from chameleonrt_tpu_torch.scene.loader import load_scene

    if uri not in _SCENES:
        path = uri
        if uri.startswith("gen://san_miguel"):
            from chameleonrt_tpu_torch import _build
            from chameleonrt_tpu_torch.scene.pbrt_gen import generate_san_miguel_proxy

            query = uri.partition("?")[2]
            kwargs = {k: int(v) for k, _, v in (kv.partition("=") for kv in query.split("&") if kv)}
            name = "_".join(["san_miguel"] + [f"{k}{v}" for k, v in sorted(kwargs.items())])
            path = generate_san_miguel_proxy(os.path.join(_build.BUILD_DIR, name), **kwargs)
        _SCENES[uri] = load_scene(path)
    return _SCENES[uri]


@contextlib.contextmanager
def _env(**values):
    """The environment with values set, as a user sets the JAX engine's
    table switches (CHAMELEONRT_WIDE_ARITY="8", ...), restored on exit."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _scene_tables(torch, uri, wide=4, leaf=4):
    """(scene, FlatScene with its tables on the card, SceneMeta), built once
    per URI, wide arity and leaf size (CHAMELEONRT_WIDE_ARITY and
    CHAMELEONRT_LEAF_SIZE during the build)."""
    from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
    from chameleonrt_tpu_torch.engine.trace_bvh import build_blas_set

    if (uri, wide, leaf) not in _TABLES:
        scene = _load(uri)
        flat, meta = build_device_scene(scene, torch.device("cuda"))
        with _env(CHAMELEONRT_WIDE_ARITY=str(wide), CHAMELEONRT_LEAF_SIZE=str(leaf)):
            _TABLES[uri, wide, leaf] = (scene, flat._replace(blas=build_blas_set(flat, meta)), meta)
    return _TABLES[uri, wide, leaf]


def _bound(table, count, active, out_bytes):
    """The least time of a kernel's call on the counted rays: the larger of
    the bytes it must move (each distinct node, leaf and entry row the rays
    visit read once, every lane's mask byte read once and its results
    written once, the ray of a live lane read once: a masked-out lane needs
    no ray) over the memory rate, and its FP32 operations (the live lanes'
    reciprocals, a slab test per live child of each visited node row, a
    Moller-Trumbore per valid slot of each visited leaf row, a transform
    per instance entry) over the FP32 rate."""
    c = dict(count.totals(), rays=active.shape[0], live=int(active.sum()))
    L = table.leaf_rows.shape[1] // 10
    row_bytes = table.nodes.shape[1] * 4
    n_bytes = (c["node_rows"] * row_bytes + c["leaf_rows"] * 10 * L * 4 + c["entry_rows"] * 14 * 4
               + c["live"] * (RAY_IN_BYTES - 1) + c["rays"] * (1 + out_bytes))
    ops = (c["live"] * RAY_OPS + c["slab_tests"] * SLAB_OPS + c["mt_slots"] * MT_OPS
           + c["entry_visits"] * ENTRY_OPS)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops, "walk": c}


def _view(scene):
    import numpy as np

    cam = scene.cameras[0]
    d = cam.center - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


def _primary_wavefront(torch, scene, W, H):
    """Sorted primary rays, as the JAX bench's _parity_wavefront builds them."""
    from chameleonrt_tpu_torch.ops import camera, rng
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

    pos, d, up, fov = _view(scene)
    view = camera.compute_view_params(pos, d, up, fov, W, H)
    ys, xs = torch.meshgrid(
        torch.arange(H, device="cuda"), torch.arange(W, device="cuda"), indexing="ij"
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    state = rng.get_rng(px + py * W, 1)
    _, orig, dirs = camera.generate_primary_rays(view, px, py, float(W), float(H), state)
    active = torch.ones(orig.shape[0], dtype=torch.bool, device="cuda")
    perm = ray_sort_perm_only(orig, dirs, active)
    return orig[perm].contiguous(), dirs[perm].contiguous(), active


def _bounce_wavefront(torch, flat, orig, dirs, t, prim, inst):
    """Diffuse-bounce rays from the primary hit points: uniform directions
    in the hemisphere of the world face normal that faces the incoming
    ray, from a seeded generator; lanes whose primary ray missed are
    inactive. inst is the hit instance (None in a flat scene, whose one
    instance is the identity)."""
    from chameleonrt_tpu_torch.ops.math import cross, dot, normalize
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

    hit = prim >= 0
    p = orig + torch.where(hit, t, torch.zeros_like(t))[:, None] * dirs
    srow = flat.shade_rows[prim.clamp(min=0).long()]
    n = cross(srow[:, 0:3], srow[:, 3:6])
    if inst is not None:
        inv3 = flat.inst_inv[inst.clamp(min=0).long(), :3, :3]
        n = torch.einsum("rji,rj->ri", inv3, n)
    n = normalize(n)
    n = torch.where((dot(n, dirs) > 0)[:, None], -n, n)
    g = torch.Generator(device="cuda").manual_seed(11)
    w = normalize(torch.randn(orig.shape, generator=g, device="cuda"))
    w = torch.where((dot(w, n) < 0)[:, None], -w, w)
    perm = ray_sort_perm_only(p, w, hit)
    return p[perm].contiguous(), w[perm].contiguous(), hit[perm].contiguous()


def _median_ms(torch, fn, reps, warmup=True):
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# each path's kernels: (label, kernel wrapper, plain version) by path and
# kind; the streamed paths' plain versions are the unstreamed ones', whose
# kernels (SAME_RAYS) are timed on their rays too
_PATHS = {
    "flat": (("B1", "traverse_closest", "traverse_closest"), ("B2", "traverse_any", "traverse_any")),
    "unified": (("B3", "traverse_closest_unified", "traverse_closest_unified"),
                ("B4", "traverse_any_unified", "traverse_any_unified")),
    "stream": (("B5a", "traverse_closest_stream", "traverse_closest"),
               ("B5b", "traverse_any_stream", "traverse_any")),
    "unified_stream": (("B5c", "traverse_closest_unified_stream", "traverse_closest_unified"),
                       ("B5d", "traverse_any_unified_stream", "traverse_any_unified")),
    "persistent": (("B6a", "traverse_closest_persistent", "traverse_closest"),
                   ("B6b", "traverse_any_persistent", "traverse_any")),
    "unified_persistent": (("B6c", "traverse_closest_unified_persistent", "traverse_closest_unified"),
                           ("B6d", "traverse_any_unified_persistent", "traverse_any_unified")),
    "grid_packet": (("B7a", "traverse_closest_packet", "traverse_closest"),
                    ("B7b", "traverse_any_packet", "traverse_any")),
}
SAME_RAYS = {"stream": "flat", "unified_stream": "unified"}
TWO_LEVEL = ("unified", "unified_stream", "unified_persistent")
# the kernels held to exact agreement, 0 mismatches and |dt| = |du| = |dv| =
# 0: all of them, since each walks in the plain walk's per-lane order with
# traverse_common.cuh's walks (B3/B4, B5c/B5d and B6c/B6d the two-level
# ones; B1, B5a, B6a, B7a and B2, B5b, B6b, B7b the closest and any walks
# over a flat table)
EXACT = ("B1", "B2", "B3", "B4", "B5a", "B5b", "B5c", "B5d", "B6a", "B6b", "B6c", "B6d", "B7a",
         "B7b")
# the kernels that keep a per-lane stack of a capacity the wrapper picks
# (traverse_cuda.stack_capacity): all of them
PER_LANE = ("B1", "B2", "B3", "B4", "B5a", "B5b", "B5c", "B5d", "B6a", "B6b", "B6c", "B6d", "B7a",
            "B7b")
# the slot-lane tiers, whose wavefronts phase 3 builds, and the work-queue
# path that traces the same scenes with the slot-lane tier off
TIERS = ("flat", "unified", "stream", "unified_stream")
QUEUE = {"flat": "persistent", "stream": "persistent",
         "unified": "unified_persistent", "unified_stream": "unified_persistent"}


def _kernel_pair(path: str, closest: bool):
    """(label, kernel wrapper, plain version) of a path's closest- or
    any-hit kernel."""
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda

    label, kernel, plain = _PATHS[path][0 if closest else 1]
    return label, getattr(traverse_cuda, kernel), getattr(traverse, plain)


def _closest_agreement(k, p, unified, exact=False):
    """A closest-hit kernel's result k against the plain result p on the
    same R rays: prim (and instance) mismatches, the largest |dt| over
    common hits and |du|, |dv| over hits on the same triangle, and whether
    they pass the gates (exact: all three 0)."""
    R = k[0].shape[0]
    tk, pk, uk, vk = k[0], k[1], k[-2], k[-1]
    tp, pp, up, vp = p[0], p[1], p[-2], p[-1]
    mism_lanes = pk != pp
    if unified:
        mism_lanes |= k[2] != p[2]
    common = (pk >= 0) & (pp >= 0)
    mism = int(mism_lanes.sum())
    dt = float((tk - tp)[common].abs().max()) if bool(common.any()) else 0.0
    # u, v are compared where both hit the same triangle: on another one
    # (a counted mismatch) they are another triangle's coordinates
    same = common & ~mism_lanes
    duv = float((uk - up).abs().maximum((vk - vp).abs())[same].max()) if bool(same.any()) else 0.0
    # the mismatches by kind: a hit that only the kernel (or only the plain
    # walk) reports, two hits on other prims at the same t (a tie), and
    # two at different t, the kernel's or the plain walk's the nearer
    both = mism_lanes & common
    return {"prim_mismatch": mism, "max_dt_common": dt, "max_duv_common": duv,
            "kernel_only_hits": int(((pk >= 0) & (pp < 0)).sum()),
            "plain_only_hits": int(((pk < 0) & (pp >= 0)).sum()),
            "tied_t_mismatch": int((both & (tk == tp)).sum()),
            "kernel_nearer": int((both & (tk < tp)).sum()),
            "plain_nearer": int((both & (tk > tp)).sum()),
            "ok": (mism == dt == duv == 0) if exact else
                  (mism <= max(2, R // 50000) and dt <= DT_TOL and duv <= UV_TOL)}


def _any_agreement(ok_k, ok_p, exact=False):
    """An any-hit kernel's flags against the plain flags on the same rays
    (exact: no mismatch)."""
    mism = int((ok_k != ok_p).sum())
    return {"occ_mismatch": mism, "max_abs_err": float((ok_k.float() - ok_p.float()).abs().max()),
            "ok": mism == 0 if exact else mism <= max(2, ok_k.shape[0] // 50000)}


def _deepened(table):
    """The table with a certified bound of MAX_STACK - 1, so that a per-lane
    kernel launches its MAX_STACK-entry instantiation on it; the walk is the
    same, since the true bound is lower."""
    from chameleonrt_tpu_torch import _build

    if hasattr(table, "stack_bound"):
        return table._replace(stack_bound=_build.MAX_STACK - 1)
    return table._replace(max_depth=_build.MAX_STACK - 1)


def _time_at_max_stack(torch, res, kernel, args, want):
    """A per-lane kernel on the same rays at its MAX_STACK instantiation
    (_deepened table): its result must equal want, the result at its
    64-entry one; its time goes into res["ms_stack128"]."""
    deep = (_deepened(args[0]),) + tuple(args[1:])
    got = kernel(*deep)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(x, y)) for x, y in zip(got, want)) if isinstance(got, tuple) \
        else bool(torch.equal(got, want))
    if not same:
        raise AssertionError(f"{kernel.__name__} differs between its stack capacities")
    res["ms_stack128"] = _median_ms(torch, lambda: kernel(*deep), KERNEL_REPS)


@contextlib.contextmanager
def _sentinel_outputs(torch):
    """Within it torch.empty and torch.empty_like fill what they allocate:
    NaN in a float tensor, INT_SENTINEL in an integer one, the byte
    BOOL_SENTINEL in a bool one. A kernel's wrapper allocates its outputs,
    and a work-queue kernel's counter, with them, so a lane that the kernel
    never writes keeps its sentinel, and a counter that is not reset before
    the launch hands out no ray."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(x):
        if x.dtype == torch.bool:
            x.view(torch.uint8).fill_(BOOL_SENTINEL)
        elif x.dtype.is_floating_point:
            x.fill_(float("nan"))
        else:
            x.fill_(INT_SENTINEL)
        return x

    torch.empty = lambda *a, **k: fill(empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def _check_queue(torch, path, closest, args, ref, max_stack=False):
    """The work-queue kernel that traces path's scenes with the slot-lane
    tier off (QUEUE: B6a-B6d) on the rays of one of phase 3's checks
    (args, as the tier's kernel took them), against ref, the plain result
    already computed on those rays: its outputs start as sentinels
    (_sentinel_outputs), of which none may survive, and it must pass the
    tier kernel's gates; the same on the first SMALL_R rays alone (each
    lane of the plain walk is independent, so ref's first lanes are their
    plain result); then its time, median of KERNEL_REPS, and with max_stack
    its time at its MAX_STACK instantiation (_time_at_max_stack). Every
    work-queue kernel meets the gate exactly (EXACT)."""
    unified = path in TWO_LEVEL
    name, kernel, _ = _kernel_pair(QUEUE[path], closest)
    exact = name in EXACT

    def check(call_args, want):
        with _sentinel_outputs(torch):
            got = kernel(*call_args)
        torch.cuda.synchronize()
        if closest:
            left = (any(bool(torch.isnan(x).any()) for x in (got[0], got[-2], got[-1]))
                    or any(bool((x == INT_SENTINEL).any()) for x in got[1:-2]))
            agree = _closest_agreement(got, want, unified, exact)
        else:
            left = bool((got.view(torch.uint8) > 1).any())
            agree = {"ok": False} if left else _any_agreement(got, want, exact)
        return {**agree, "sentinels_left": left, "ok": agree["ok"] and not left}

    res = {"kernel": name, **check(args, ref)}
    small_args = (args[0],) + tuple(a[:SMALL_R] for a in args[1:])
    res["small"] = check(small_args, tuple(x[:SMALL_R] for x in ref) if closest else ref[:SMALL_R])
    res["small"]["rays"] = SMALL_R
    res["ok"] = res["ok"] and res["small"]["ok"]
    res["ms"] = _median_ms(torch, lambda: kernel(*args), KERNEL_REPS)
    if max_stack:
        _time_at_max_stack(torch, res, kernel, args, kernel(*args))
    return res


def _time_also(torch, res, path, closest, args, also):
    """Time other kernels on the same rays into res: also maps a result key
    to (kernel wrapper, table); None gives a streamed path's unstreamed
    kernel on the same table (SAME_RAYS, e.g. flat_ms)."""
    if also is None:
        also = {}
        if path in SAME_RAYS:
            also[f"{SAME_RAYS[path]}_ms"] = (_kernel_pair(SAME_RAYS[path], closest)[1], args[0])
    for key, (other, table) in also.items():
        res[key] = _median_ms(torch, lambda: other(table, *args[1:]), KERNEL_REPS)


def _raise_unless_ok(res, name, label):
    queue = res.get("queue", {"ok": True, "kernel": "-"})
    if not res["ok"] or not queue["ok"]:
        raise AssertionError(f"{name} or {queue['kernel']} disagrees with its plain version "
                             f"on {label}: {res}")


def _check_closest(torch, table, path, orig, dirs, t_min, active, label, plain_reps, bound=False,
                   also=None):
    """Kernel against plain closest hit; returns (result, t, prim, inst)
    of the plain version (inst None in a flat scene). Other kernels are
    timed on the same rays (_time_also). A path whose scenes a work-queue
    kernel also traces (QUEUE) checks that kernel on the same rays.
    bound: count the plain walk and give the kernel's least time, and
    time a per-lane kernel (and the work-queue one) at its MAX_STACK
    instantiation too."""
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.traverse import WalkCount

    unified = path in TWO_LEVEL
    name, kernel, plain = _kernel_pair(path, closest=True)
    R = orig.shape[0]
    t_max = torch.full((R,), T_MAX, dtype=torch.float32, device="cuda")
    args = (table, orig, dirs, t_min, active, t_max)
    k = kernel(*args)
    torch.cuda.synchronize()
    count = WalkCount(table) if bound else None
    p = plain(*args, count=count)
    pk = k[1]
    res = {"rays": R, "active": int(active.sum()), "hits": int((pk >= 0).sum()),
           "overflows": int((pk == -2).sum()), **_closest_agreement(k, p, unified, name in EXACT)}
    if unified:
        res["instances_hit"] = int(torch.unique(k[2][pk >= 0]).numel())
    if bound:
        res.update(_bound(table, count, active, 20 if unified else 16))
    res["ms"] = _median_ms(torch, lambda: kernel(*args), KERNEL_REPS)
    if bound and name in PER_LANE:
        _time_at_max_stack(torch, res, kernel, args, k)
    _time_also(torch, res, path, True, args, also)
    if path in QUEUE:
        res["queue"] = _check_queue(torch, path, True, args, p, max_stack=bound)
    res["plain_ms"] = _median_ms(torch, lambda: plain(*args), plain_reps, warmup=False)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} closest {label}: {json.dumps(res)}")
    _raise_unless_ok(res, name, label)
    return res, p[0], p[1], (p[2] if unified else None)


def _check_any(torch, table, path, orig, dirs, t_closest, active, label, factor, plain_reps,
               bound=False, also=None):
    """t_max = factor * the closest hit (100 on a miss). factor 1.001 is the
    JAX bench's gate: a hitting ray is occluded, mostly by that very
    triangle, and stops early. factor 0.999 stops just short of it, so a ray
    walks every box in front of its hit and is rarely occluded. bound,
    also and the work-queue kernel as in _check_closest."""
    from chameleonrt_tpu_torch.ops.math import EPSILON
    from chameleonrt_tpu_torch.ops.traverse import WalkCount

    name, kernel, plain = _kernel_pair(path, closest=False)
    R = orig.shape[0]
    t_max = torch.where(t_closest < 1e19, t_closest * factor, torch.full_like(t_closest, 100.0))
    t_min = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
    args = (table, orig, dirs, t_min, t_max, active)
    ok_k = kernel(*args)
    torch.cuda.synchronize()
    count = WalkCount(table) if bound else None
    ok_p = plain(*args, count=count)
    res = {"rays": R, "t_max_factor": factor, "occluded": int(ok_k.sum()),
           **_any_agreement(ok_k, ok_p, name in EXACT)}
    if bound:
        res.update(_bound(table, count, active, 1))
    res["ms"] = _median_ms(torch, lambda: kernel(*args), KERNEL_REPS)
    if bound and name in PER_LANE:
        _time_at_max_stack(torch, res, kernel, args, ok_k)
    _time_also(torch, res, path, False, args, also)
    if path in QUEUE:
        res["queue"] = _check_queue(torch, path, False, args, ok_p, max_stack=bound)
    res["plain_ms"] = _median_ms(torch, lambda: plain(*args), plain_reps, warmup=False)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} any {label}: {json.dumps(res)}")
    _raise_unless_ok(res, name, label)
    return res


# launch-count key of each path's any-hit kernel
_ANY_COUNT = {"flat": "any", "unified": "any_unified", "stream": "any_stream",
              "unified_stream": "any_unified_stream", "persistent": "any_persistent",
              "unified_persistent": "any_unified_persistent", "grid_packet": "any_packet"}


def _shadow_calls(torch, scene, tables, W, H, spp=1, **backend):
    """One W x H frame at spp samples a pixel through CudaBackend(**backend)
    on the scene's tables (already built), with every trace_any call
    captured. Returns (backend, calls): calls in call order (per bounce the
    light samples, then the bsdf samples toward the lights), each (orig,
    dir, t_max, mask, occluded) as the call saw and returned them."""
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend

    b = CudaBackend(**backend)
    b.prepare_scene = lambda _scene: tables
    b.initialize(W, H)
    b.set_scene(scene)
    b.samples_per_pixel = spp
    trace_closest, trace_any = b._trace
    calls = []

    def capture(flat, orig, dir, t_max, mask):
        occ = trace_any(flat, orig, dir, t_max, mask)
        calls.append((orig.clone(), dir.clone(), t_max.clone(), mask.clone(), occ.clone()))
        return occ

    b._trace = (trace_closest, capture)
    b.render(*_view(scene), True, readback_framebuffer=False)
    return b, calls


def _check_any_shadow(torch, scene, tables, path, W, H, spp=1):
    """The any-hit kernel on a main path's own traffic: the 10 masked
    shadow-ray wavefronts of one W x H frame at one sample per pixel
    (_shadow_calls), captured through the backend and traced again by the
    plain version on the same table. Requires zero mismatches, some
    occluded rays, and 10 launches of the path's any-hit kernel, so on a
    streamed path the gate must have picked it. A work-queue path (QUEUE's
    values) renders with the slot-lane tier off, the others with it on; the
    grid-packet path renders with grid_packet=True, and traces the binary
    table. The kernel is also timed on each wavefront (median of
    KERNEL_REPS) beside its bound there (_bound, from the plain walk's
    WalkCount on those rays), and a streamed or grid-packet flat kernel
    (B5b, B7b) beside B2 on the same table and rays (flat_ms). rays_sha256
    digests the captured rays and masks, so two paths' frames can be shown
    to have traced the same wavefronts."""
    import hashlib

    from chameleonrt_tpu_torch.ops import traverse_cuda
    from chameleonrt_tpu_torch.ops.math import EPSILON
    from chameleonrt_tpu_torch.ops.traverse import WalkCount

    name, kernel, plain = _kernel_pair(path, closest=False)
    count = _ANY_COUNT[path]
    grid_packet = path == "grid_packet"
    before = traverse_cuda.LAUNCHES[count]
    b, calls = _shadow_calls(torch, scene, tables, W, H, spp, slotlane=path not in QUEUE.values(),
                             grid_packet=grid_packet)
    launched = traverse_cuda.LAUNCHES[count] - before
    table = b.flat.blas[0].closest if grid_packet else b.flat.blas[0].any
    beside_b2 = path in ("stream", "grid_packet")
    per_call, timed = [], {"ms": [], "bound_ms": [], "bound_by": []}
    if beside_b2:
        timed["flat_ms"] = []
    digest = hashlib.sha256()
    for orig, dirs, t_max, mask, occ in calls:
        for x in (orig, dirs, t_max, mask):
            digest.update(x.cpu().numpy().tobytes())
        args = (table, orig, dirs, torch.full_like(t_max, EPSILON), t_max, mask)
        walk = WalkCount(table)
        occ_p = plain(*args, count=walk)
        bound = _bound(table, walk, mask, 1)
        timed["ms"].append(_median_ms(torch, lambda: kernel(*args), KERNEL_REPS))
        timed["bound_ms"].append(bound["bound_ms"])
        timed["bound_by"].append(bound["bound_by"])
        if beside_b2:
            timed["flat_ms"].append(_median_ms(torch, lambda: traverse_cuda.traverse_any(*args),
                                               KERNEL_REPS))
        per_call.append((int(mask.sum()), int(occ.sum()), int((occ != occ_p).sum())))
    res = {"rays": W * H, "spp": spp, "calls": len(calls), "launches": launched,
           "masked_in": [c[0] for c in per_call], "occluded": [c[1] for c in per_call],
           "occ_mismatch": sum(c[2] for c in per_call), "rays_sha256": digest.hexdigest(), **timed}
    res.update({f"{k}_sum": sum(v) for k, v in timed.items() if k != "bound_by"})
    res["ok"] = (len(calls) == 10 and launched == 10 and res["occ_mismatch"] == 0
                 and sum(res["occluded"]) > 0 and all(0 < c[0] < W * H for c in per_call[:2]))
    log(f"[kernels] {name} any main-path shadow rays, one {W}x{H} frame: {json.dumps(res)}")
    if not res["ok"]:
        raise AssertionError(f"{name} disagrees with its plain version on the main path's shadow rays: {res}")
    return res


# the backend options of the main paths whose closest hit _check_closest_frame
# holds on a frame's own wavefronts
_CLOSEST_FRAME = {"flat": {}, "stream": {}, "persistent": {"slotlane": False},
                  "grid_packet": {"grid_packet": True}}


def _closest_frame_calls(torch, scene, tables, path, W, H):
    """The 5 closest-hit wavefronts of one W x H frame at one sample per
    pixel through CudaBackend(**_CLOSEST_FRAME[path]) on the scene's tables
    (already built), captured at the path's closest-hit kernel's wrapper as
    the backend calls it: [(table, (orig, dir, t_min, active, t_max),
    result)] in call order."""
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    wrapper = _PATHS[path][0][1]
    real = getattr(traverse_cuda, wrapper)
    calls = []

    def capture(table, *args):
        out = real(table, *args)
        calls.append((table, tuple(a.clone() for a in args), tuple(x.clone() for x in out)))
        return out

    setattr(traverse_cuda, wrapper, capture)
    try:
        b = CudaBackend(**_CLOSEST_FRAME[path])
        b.prepare_scene = lambda _scene: tables
        b.initialize(W, H)
        b.set_scene(scene)
        b.render(*_view(scene), True, readback_framebuffer=False)
    finally:
        setattr(traverse_cuda, wrapper, real)
    return calls


def _check_closest_frame(torch, scene, tables, path, W, H):
    """A flat closest-hit kernel (B1, B5a, B6a, B7a) on its main path's own
    traffic: the 5 closest-hit wavefronts of one W x H frame at one sample
    per pixel (_closest_frame_calls: the stream path's gate must route the
    scene there, the persistent path renders with the slot-lane tier off),
    each held exactly against the plain walk on the same table and rays,
    and timed (median of KERNEL_REPS) beside B1 on the same rays and beside
    its bound there (_bound, from the plain walk's WalkCount)."""
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda

    name, wrapper, _ = _PATHS[path][0]
    real = getattr(traverse_cuda, wrapper)
    calls = _closest_frame_calls(torch, scene, tables, path, W, H)
    res = {"rays": W * H, "calls": len(calls), "active": [], "hits": [], "prim_mismatch": 0,
           "max_dt_common": 0.0, "max_duv_common": 0.0, "exact": True, "ms": [], "flat_ms": [],
           "bound_ms": [], "bound_by": []}
    for table, args, got in calls:
        walk = traverse.WalkCount(table)
        want = traverse.traverse_closest(table, *args, count=walk)
        agree = _closest_agreement(got, want, False, exact=True)
        res["active"].append(int(args[3].sum()))
        res["hits"].append(int((want[1] >= 0).sum()))
        res["prim_mismatch"] += agree["prim_mismatch"]
        res["max_dt_common"] = max(res["max_dt_common"], agree["max_dt_common"])
        res["max_duv_common"] = max(res["max_duv_common"], agree["max_duv_common"])
        res["exact"] = res["exact"] and all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        bound = _bound(table, walk, args[3], 16)
        res["ms"].append(_median_ms(torch, lambda: real(table, *args), KERNEL_REPS))
        res["flat_ms"].append(_median_ms(torch, lambda: traverse_cuda.traverse_closest(table, *args),
                                         KERNEL_REPS))
        res["bound_ms"].append(bound["bound_ms"])
        res["bound_by"].append(bound["bound_by"])
    res.update({f"{k}_sum": sum(res[k]) for k in ("ms", "flat_ms", "bound_ms")})
    res["ok"] = len(calls) == 5 and res["exact"] and sum(res["hits"]) > 0
    log(f"[kernels] {name} closest main-path wavefronts, one {W}x{H} frame: {json.dumps(res)}")
    if not res["ok"]:
        raise AssertionError(f"{name} differs from the plain walk on the main path's closest-hit "
                             f"wavefronts: {res}")
    return res


def phase_kernels(torch, path: str):
    """The closest- and any-hit kernels of one path against their plain
    versions on two scenes, with kernel and plain times and, on the main
    path's primary wavefront, the kernels' least times; then the any-hit
    kernel on one main-path frame's shadow rays. Every check also holds
    the work-queue kernel of the path's scenes (QUEUE) on the same rays
    (_check_queue); on the flat and unified paths the work-queue any-hit
    kernel also traces the shadow rays of one main-path frame. Returns
    {"closest": (primary, bounce), "any": (primary, bounce), "any_all":
    [...], "shadow": ..., "queue_all": {"closest": [...], "any": [...]},
    ["queue_shadow": ...]}: the first at the main path's shape, queue_all
    over every scene. A streamed path checks any hit at both t_max factors
    on both wavefronts, times the unstreamed kernels beside its own, and
    asserts that the gate routes its main-path scene to the streamed tier;
    the unified path asserts that it does not."""
    from chameleonrt_tpu_torch.engine.trace_bvh import streamed_tier, table_bytes
    from chameleonrt_tpu_torch.ops.math import EPSILON
    from chameleonrt_tpu_torch.ops.traverse_cuda import stack_capacity, stack_depth

    cases = {
        "flat": (("parity hall subdiv=2 320x180", HALL_PARITY, 320, 180, PLAIN_REPS),
                 ("main-path hall 1280x720", HALL_SCENE, MAIN_W, MAIN_H, PLAIN_REPS)),
        "unified": (("parity instances nx=4 ny=4 320x180", INST_PARITY, 320, 180, PLAIN_REPS),
                    ("main-path San Miguel proxy 1280x720", SAN_MIGUEL, MAIN_W, MAIN_H,
                     PLAIN_REPS_SAN_MIGUEL)),
        "stream": (("parity city n=60 320x180", CITY_PARITY, 320, 180, PLAIN_REPS),
                   ("main-path city n=610 640x360", CITY_SCENE, CITY_W, CITY_H, PLAIN_REPS_CITY)),
        "unified_stream": (("parity instances nx=4 ny=4 320x180", INST_PARITY, 320, 180, PLAIN_REPS),
                           ("main-path large San Miguel proxy 1280x720", SAN_MIGUEL_LARGE,
                            MAIN_W, MAIN_H, PLAIN_REPS_LARGE)),
    }[path]
    stream = path in SAME_RAYS
    factors = ((1.001, 0.999), (1.001, 0.999)) if stream else ((1.001,), (0.999,))
    out = {}
    queue_all = {"closest": [], "any": []}
    for label, uri, W, H, reps in cases:
        main_case = uri == cases[-1][1]
        scene, flat, meta = _scene_tables(torch, uri)
        table = flat.blas[0].any
        tier = streamed_tier(table)
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        if path in TWO_LEVEL:
            log(f"[kernels] {label}: two-level BVH4 table {tuple(table.nodes.shape)} nodes, "
                f"{tuple(table.leaf_rows.shape)} leaf rows, n_tri_leaves {table.n_tri_leaves}, "
                f"tlas_lo {table.tlas_lo}, stack_bound {table.stack_bound}, "
                f"{meta.num_instances} instances of {len(meta.mesh_tri_ranges)} meshes, "
                f"{meta.num_tris} unique tris, {table_bytes(table)} bytes against an L2 of {l2}: "
                f"streamed tier by the gate {tier}; stack capacity "
                f"{stack_capacity(stack_depth(table))}")
        else:
            log(f"[kernels] {label}: {meta.num_tris} tris, BVH4 table {tuple(table.nodes.shape)} "
                f"nodes, {tuple(table.leaf_rows.shape)} leaf rows, {table_bytes(table)} bytes "
                f"against an L2 of {l2}: streamed tier by the gate {tier}; max_depth {table.max_depth}")
        if main_case and tier != stream:
            raise AssertionError(f"the gate routes {uri} to the {'streamed' if tier else 'unstreamed'} "
                                 f"tier, the {path} path expects the other")
        orig, dirs, active = _primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        zeros = torch.zeros((R,), dtype=torch.float32, device="cuda")
        r1, t, prim, inst = _check_closest(torch, table, path, orig, dirs, zeros, active,
                                           f"{label} primary", reps, bound=main_case)
        a1 = [_check_any(torch, table, path, orig, dirs, t, active, f"{label} primary", f, reps,
                         bound=main_case and f == factors[0][0])
              for f in factors[0]]
        bo, bd, bact = _bounce_wavefront(torch, flat, orig, dirs, t, prim, inst)
        eps = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
        r3, bt, _, _ = _check_closest(torch, table, path, bo, bd, eps, bact, f"{label} bounce", reps,
                                      bound=main_case)
        a2 = [_check_any(torch, table, path, bo, bd, bt, bact, f"{label} bounce", f, reps,
                         bound=main_case and f == factors[1][-1])
              for f in factors[1]]
        out = {"closest": (r1, r3), "any": (a1[0], a2[-1]), "any_all": a1 + a2}
        queue_all["closest"] += [r1["queue"], r3["queue"]]
        queue_all["any"] += [a["queue"] for a in a1 + a2]
    out["queue_all"] = queue_all
    # the last case is the main path's scene: its tables serve the shadow check
    W, H = (CITY_W, CITY_H) if path == "stream" else (MAIN_W, MAIN_H)
    out["shadow"] = _check_any_shadow(torch, scene, (flat, meta), path, W, H)
    if path in _CLOSEST_FRAME:
        out["frame"] = _check_closest_frame(torch, scene, (flat, meta), path, W, H)
    if path in ("flat", "unified"):
        out["queue_shadow"] = q = _check_any_shadow(torch, scene, (flat, meta), QUEUE[path], W, H)
        q["same_rays"] = q["rays_sha256"] == out["shadow"]["rays_sha256"]
        log(f"[kernels] {QUEUE[path]} shadow rays equal to {path}'s: {q['same_rays']}")
    if path == "flat":  # B6a on the slotlane=False hall frame's closest-hit wavefronts
        out["queue_frame"] = _check_closest_frame(torch, scene, (flat, meta), QUEUE[path], W, H)
    return out


def phase_packet(torch):
    """The grid-packet kernels B7a/B7b against their plain versions on the
    hall's binary table (flat.blas[0].closest): the parity hall at 320x180
    and the main-path hall at 1280x720, closest hit and any hit at both
    t_max factors on the primary and the bounce wavefront, with B1 (closest
    hit) and B2 (any hit) timed on the same rays on the binary table
    (flat_binary_ms) and on the BVH4 table (flat_ms), and the kernels' least
    times on the main-path primary wavefront; then B7b on the shadow rays of
    one grid_packet=True frame, beside B2 on the binary table.
    Returns phase_kernels' form: {"closest": (primary, bounce), "any":
    (primary, bounce), "any_all": [...], "shadow": ...}."""
    from chameleonrt_tpu_torch.ops import traverse_cuda
    from chameleonrt_tpu_torch.ops.math import EPSILON

    cases = (("parity hall subdiv=2 320x180", HALL_PARITY, 320, 180, PLAIN_REPS),
             ("main-path hall 1280x720", HALL_SCENE, MAIN_W, MAIN_H, PLAIN_REPS_PACKET))
    out = {}
    for label, uri, W, H, reps in cases:
        main_case = uri == HALL_SCENE
        scene, flat, meta = _scene_tables(torch, uri)
        table = flat.blas[0].closest
        log(f"[kernels] {label}: binary table {tuple(table.nodes.shape)} nodes, "
            f"{tuple(table.leaf_rows.shape)} leaf rows, max_depth {table.max_depth}")
        also = {
            True: {"flat_binary_ms": (traverse_cuda.traverse_closest, table),
                   "flat_ms": (traverse_cuda.traverse_closest, flat.blas[0].any)},
            False: {"flat_binary_ms": (traverse_cuda.traverse_any, table),
                    "flat_ms": (traverse_cuda.traverse_any, flat.blas[0].any)},
        }
        orig, dirs, active = _primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        zeros = torch.zeros((R,), dtype=torch.float32, device="cuda")
        r1, t, prim, _ = _check_closest(torch, table, "grid_packet", orig, dirs, zeros, active,
                                        f"{label} primary", reps, bound=main_case, also=also[True])
        a1 = [_check_any(torch, table, "grid_packet", orig, dirs, t, active, f"{label} primary", f,
                         reps, bound=main_case and f == 1.001, also=also[False])
              for f in (1.001, 0.999)]
        bo, bd, bact = _bounce_wavefront(torch, flat, orig, dirs, t, prim, None)
        eps = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
        r3, bt, _, _ = _check_closest(torch, table, "grid_packet", bo, bd, eps, bact,
                                      f"{label} bounce", reps, bound=main_case, also=also[True])
        a2 = [_check_any(torch, table, "grid_packet", bo, bd, bt, bact, f"{label} bounce", f, reps,
                         bound=main_case and f == 0.999, also=also[False])
              for f in (1.001, 0.999)]
        out = {"closest": (r1, r3), "any": (a1[0], a2[-1]), "any_all": a1 + a2}
    out["shadow"] = _check_any_shadow(torch, scene, (flat, meta), "grid_packet", MAIN_W, MAIN_H)
    out["frame"] = _check_closest_frame(torch, scene, (flat, meta), "grid_packet", MAIN_W, MAIN_H)
    return out


# B1-B6d at each arity: (label, scene, paths whose kernels trace it, leaf
# size); the streamed paths are forced onto these tables, which fit the
# L2. The last two hold the two-level kernels to odd leaf sizes, whose
# 40L-byte rows start 8 bytes past 16 at every other row.
GRID_24 = "proc://instances?nx=24&ny=24&subdiv=0"
ARITY_CASES = (
    ("parity hall subdiv=2 320x180", HALL_PARITY, ("flat", "persistent"), 4),
    ("parity city n=60 320x180", CITY_PARITY, ("stream",), 4),
    ("parity instances nx=4 ny=4 320x180", INST_PARITY, TWO_LEVEL, 4),
    ("instances nx=24 ny=24 L=5 320x180", GRID_24, TWO_LEVEL, 5),
    ("instances nx=24 ny=24 L=9 320x180", GRID_24, TWO_LEVEL, 9),
)
ARITIES = (2, 4, 8)


def phase_arities(torch):
    """B1-B6d at every arity they take: on the primary wavefront of each
    ARITY_CASES scene at 320x180 and its leaf size, the binary table (A =
    2), the BVH4 table (A = 4) and the BVH8 table (A = 8, built with
    CHAMELEONRT_WIDE_ARITY=8), each path's closest-hit kernel against the
    plain closest hit on the same table, and its any-hit kernel against the
    plain any hit at t_max = 1.001 x that hit, under the gates of phase 3
    (EXACT's kernels exact). Returns {label: {arity: {"max_abs_err", "mismatch",
    "ms"}}}: the worst |dt| (closest hit) or flag difference (any hit) over
    the scenes of the kernel."""
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.math import EPSILON

    out = {}
    for label, uri, paths, leaf in ARITY_CASES:
        for arity in ARITIES:
            scene, flat, _ = _scene_tables(torch, uri, wide=8 if arity == 8 else 4, leaf=leaf)
            table = flat.blas[0].closest if arity == 2 else flat.blas[0].any
            if table.nodes.shape[1] != 8 * arity:
                raise AssertionError(f"{uri}: expected rows of {8 * arity} floats, got {tuple(table.nodes.shape)}")
            orig, dirs, active = _primary_wavefront(torch, scene, 320, 180)
            R = orig.shape[0]
            t_min = torch.zeros((R,), dtype=torch.float32, device="cuda")
            c_args = (table, orig, dirs, t_min, active, torch.full((R,), T_MAX, device="cuda"))
            _, _, plain_c = _kernel_pair(paths[0], True)
            p = plain_c(*c_args)
            t_max = torch.where(p[0] < 1e19, p[0] * 1.001, torch.full_like(p[0], 100.0))
            a_args = (table, orig, dirs, torch.full((R,), EPSILON, device="cuda"), t_max, active)
            _, _, plain_a = _kernel_pair(paths[0], False)
            occ_p = plain_a(*a_args)
            line = {"rays": R, "rows": tuple(table.nodes.shape), "stack": table.stack_bound
                    if hasattr(table, "stack_bound") else table.max_depth}
            for path in paths:
                for closest, args in ((True, c_args), (False, a_args)):
                    name, kernel, _ = _kernel_pair(path, closest)
                    got = kernel(*args)
                    torch.cuda.synchronize()
                    if closest:
                        agree = _closest_agreement(got, p, path in TWO_LEVEL, name in EXACT)
                        err, mism = agree["max_dt_common"], agree["prim_mismatch"]
                    else:
                        agree = _any_agreement(got, occ_p, name in EXACT)
                        err, mism = agree["max_abs_err"], agree["occ_mismatch"]
                    ms = _median_ms(torch, lambda: kernel(*args), KERNEL_REPS)
                    line[name] = {"max_abs_err": err, "mismatch": mism, "ms": ms}
                    prev = out.setdefault(name, {}).get(arity)
                    out[name][arity] = {
                        "max_abs_err": max(err, prev["max_abs_err"]) if prev else err,
                        "mismatch": mism + (prev["mismatch"] if prev else 0),
                        "ms": {**(prev["ms"] if prev else {}), label: ms}}
                    if not agree["ok"]:
                        raise AssertionError(f"{name} at arity {arity} disagrees with its plain "
                                             f"version on {label}: {agree}")
            log(f"[arity] {label} A={arity}: {json.dumps(line)}")
    return out


def _stack_launches(before):
    """{launch-count key: {capacity: launches}} since before, a copy of
    traverse_cuda.STACK_LAUNCHES: the stack capacity each launch ran with."""
    from chameleonrt_tpu_torch.ops import traverse_cuda

    out = {}
    for key, caps in traverse_cuda.STACK_LAUNCHES.items():
        moved = {cap: n - before[key][cap] for cap, n in caps.items() if n != before[key][cap]}
        if moved:
            out[key] = moved
    return out


def _snapshot_stacks():
    from chameleonrt_tpu_torch.ops import traverse_cuda

    return {k: dict(v) for k, v in traverse_cuda.STACK_LAUNCHES.items()}


# C3 on the card: each main-path scene's BVH8 table (CHAMELEONRT_WIDE_ARITY
# =8) and the paths whose kernels trace it there, on its main-path primary
# wavefront: (label, scene, width, height, paths)
C3_CASES = (
    ("San Miguel proxy 1280x720", SAN_MIGUEL, MAIN_W, MAIN_H, ("unified", "unified_persistent")),
    ("large San Miguel proxy 1280x720", SAN_MIGUEL_LARGE, MAIN_W, MAIN_H, ("unified_stream",)),
    ("city n=610 640x360", CITY_SCENE, CITY_W, CITY_H, ("stream",)),
)


def phase_bvh8(torch):
    """C3, stacks deeper than 64: the stack each main-path scene's BVH8
    table needs (certified bound + 1, against MAX_STACK); on the C3_CASES
    scenes, whose BVH8 stacks exceed 64, each path's closest-hit kernel
    against the plain walk on the main-path primary wavefront, and its
    any-hit kernel at t_max = 1.001 x that hit, under phase 3's gates
    (EXACT's kernels meet them exactly), with the stack
    capacity each launch ran with; then a BVH8 San Miguel image (phase 4's
    size) against the plain walk. Returns {"stacks": {scene: need},
    "cases": {label: {kernel: {...}}}}."""
    from chameleonrt_tpu_torch import _build
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.math import EPSILON
    from chameleonrt_tpu_torch.ops.traverse_cuda import stack_capacity, stack_depth

    stacks = {}
    for uri in (HALL_SCENE, SAN_MIGUEL, CITY_SCENE, SAN_MIGUEL_LARGE):
        stacks[uri] = stack_depth(_scene_tables(torch, uri, wide=8)[1].blas[0].any)
        if uri == HALL_SCENE:
            del _TABLES[uri, 8, 4]
    log(f"[bvh8] BVH8 stack needs (certified bound + 1) against MAX_STACK {_build.MAX_STACK}: "
        f"{json.dumps(stacks)}")
    cases = {}
    for label, uri, W, H, paths in C3_CASES:
        scene, _, _ = _scene_tables(torch, uri, wide=8)
        table = _TABLES[uri, 8, 4][1].blas[0].any
        if stack_capacity(stack_depth(table)) != _build.MAX_STACK:
            raise AssertionError(f"{uri}'s BVH8 stack {stack_depth(table)} fits the 64-entry kernels")
        orig, dirs, active = _primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        c_args = (table, orig, dirs, torch.zeros((R,), device="cuda"), active,
                  torch.full((R,), T_MAX, device="cuda"))
        p = _kernel_pair(paths[0], True)[2](*c_args)
        t_max = torch.where(p[0] < 1e19, p[0] * 1.001, torch.full_like(p[0], 100.0))
        a_args = (table, orig, dirs, torch.full((R,), EPSILON, device="cuda"), t_max, active)
        occ_p = _kernel_pair(paths[0], False)[2](*a_args)
        res = {"rays": R, "rows": tuple(table.nodes.shape), "stack": stack_depth(table)}
        for path in paths:
            for closest, args in ((True, c_args), (False, a_args)):
                name, kernel, _ = _kernel_pair(path, closest)
                before = _snapshot_stacks()
                got = kernel(*args)
                torch.cuda.synchronize()
                exact = name in EXACT
                agree = (_closest_agreement(got, p, path in TWO_LEVEL, exact) if closest
                         else _any_agreement(got, occ_p, exact))
                res[name] = {**agree, "stack_launches": _stack_launches(before),
                             "ms": _median_ms(torch, lambda: kernel(*args), KERNEL_REPS)}
                if not agree["ok"]:
                    raise AssertionError(f"{name} on {label}'s BVH8 table disagrees with its plain "
                                         f"version: {res[name]}")
        log(f"[bvh8] {label}: {json.dumps(res)}")
        cases[label] = res
        del _TABLES[uri, 8, 4]
    with _env(CHAMELEONRT_WIDE_ARITY="8"):
        before = _snapshot_stacks()
        phase_image(torch, SAN_MIGUEL, expect={"closest_unified", "any_unified"},
                    tables=(16, 64, 40))
        caps = _stack_launches(before)
    log(f"[bvh8] San Miguel image launches by stack capacity: {json.dumps(caps)}")
    if set(caps) != {"closest_unified", "any_unified"} or any(
            set(c) != {_build.MAX_STACK} for c in caps.values()):
        raise AssertionError(f"the BVH8 San Miguel image launched {caps}")
    return {"stacks": stacks, "cases": cases}


def _queue_grids(torch):
    """The work-queue kernels' grids as their first launches sized them:
    resident blocks of 128 threads on the card, by label, arity and stack
    capacity (0 for an instantiation that never launched)."""
    from chameleonrt_tpu_torch import _build

    lib = _build.kernels()
    grids = {label: {f"{a}@{cap}": lib.crt_persistent_blocks(i, a, cap)
                     for a in ARITIES for cap in _build.STACK_CAPACITIES}
             for i, label in enumerate(("B6a", "B6b", "B6c", "B6d"))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[kernels] work-queue grids (blocks of 128 threads, {sms} SMs) by arity@capacity: "
        f"{json.dumps(grids)}")
    return grids


def phase_image(torch, uri, stream=None, expect=None, slotlane=True, grid_packet=False, tables=None):
    """Two 128x72 frames through the kernels against two through the plain
    traversal, under the environment as it stands (phase 4 sets the table
    switches around some calls). stream=True forces the streamed tier,
    slotlane=False the work-queue kernels, grid_packet=True the grid-packet
    kernels; expect, if given, is the set of launch counts that must have
    moved (and no other); tables, if given, the (closest, any, leaf) row
    widths in floats that the kernels' backend must have built."""
    import numpy as np

    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    scene = _load(uri)
    pos, d, up, fov = _view(scene)
    imgs = {}
    before = dict(traverse_cuda.LAUNCHES)
    for use_kernels in (True, False):
        b = CudaBackend(use_kernels=use_kernels, stream=stream, slotlane=slotlane,
                        grid_packet=grid_packet)
        b.initialize(128, 72)
        b.set_scene(scene)
        for i in range(2):
            b.render(pos, d, up, fov, i == 0, readback_framebuffer=(i == 1))
        imgs[use_kernels] = b.img[..., :3].astype(np.float32)
        if use_kernels:
            pair = b.flat.blas[0]
            widths = (pair.closest.nodes.shape[1], pair.any.nodes.shape[1],
                      pair.any.leaf_rows.shape[1])
    diff = np.abs(imgs[True] - imgs[False])
    mad = float(diff.mean())
    launched = {k: n - before[k] for k, n in traverse_cuda.LAUNCHES.items() if n != before[k]}
    switches = {k: v for k, v in os.environ.items()
                if k in ("CHAMELEONRT_CLOSEST_ARITY", "CHAMELEONRT_WIDE_ARITY", "CHAMELEONRT_LEAF_SIZE")}
    mode = ((", stream=True" if stream else "") + ("" if slotlane else ", slotlane=False")
            + (", grid_packet=True" if grid_packet else "")
            + "".join(f", {k}={v}" for k, v in sorted(switches.items())))
    log(f"[image] {uri} 128x72 x2 frames{mode}, kernels vs plain "
        f"traversal: 8-bit mean abs diff {mad:.6f} (gate < 1.0), max {float(diff.max())}, "
        f"image mean {float(imgs[True].mean()):.3f}, launches {launched}, "
        f"row widths (closest, any, leaf) {widths}")
    if not mad < 1.0 or not imgs[True].max() > 0:
        raise AssertionError(f"kernel image of {uri} differs from the plain image or is black: MAD {mad}")
    if expect is not None and set(launched) != set(expect):
        raise AssertionError(f"{uri}{mode} launched {launched}, expected {sorted(expect)} only")
    if tables is not None and widths != tuple(tables):
        raise AssertionError(f"{uri}{mode} built rows of {widths} floats, expected {tables}")
    return mad


def _gate_image(torch, name, uri):
    """One 128x72 frame at 1 spp through get_backend(name), as the JAX
    bench's image gate renders it: (8-bit image, ms of the frame)."""
    import numpy as np

    from chameleonrt_tpu_torch.core.registry import get_backend

    scene = _load(uri)
    b = get_backend(name)
    b.initialize(GATE_W, GATE_H)
    b.set_scene(scene)
    st = b.render(*_view(scene), True)
    return b.img[..., :3].astype(np.float32), st.render_time


def _oracle_call(torch, fn, *args, **kwargs):
    """fn(*args, **kwargs) on the card: (result, seconds, peak bytes that
    the call allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before


def phase_reference(torch):
    """The brute-force `reference` backend on the card:
    - the JAX bench's image gate (bench.py:174-190): get_backend("cuda")
      against get_backend("reference"), one 128x72 frame at 1 spp, 8-bit
      MAD < 1.0, on the textured hall (B1/B2) and on the 36-instance grid
      (B3/B4, and the reference's loop over the instances);
    - the oracle against B1 and B2 through the engine's trace functions
      (engine/trace_bvh.py, the BVH4 table, B1/B2 forced) on the main
      path's textured hall (224,768 triangles), on a sorted 320x180
      primary wavefront and its diffuse-bounce wavefront: closest hit, and
      any hit from EPSILON to 1.001 of each hit on even lanes and to 0.999
      on odd lanes (100 on a miss; nothing lies nearer than the hit, so an
      odd lane that hits is occluded only if t_max is ignored), held to
      bench.py:157-170 (mismatches <= max(2, R / 50000), |dt| and, on the
      same triangle, |du|, |dv| <= 1e-5), with each oracle call's seconds
      and peak memory;
    - the reference backend's ms per frame at 128x72 (median of
      REFERENCE_FRAMES after one warmup)."""
    import numpy as np

    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.engine import trace_bruteforce, trace_bvh
    from chameleonrt_tpu_torch.ops import traverse_cuda
    from chameleonrt_tpu_torch.ops.intersect import MAX_PAIRS
    from chameleonrt_tpu_torch.ops.math import EPSILON

    out = {"gate": {}}
    for uri, kernels in ((HALL_IMAGE, {"closest", "any"}),
                         (INST_IMAGE, {"closest_unified", "any_unified"})):
        before = dict(traverse_cuda.LAUNCHES)
        img_k, ms_k = _gate_image(torch, "cuda", uri)
        launched = {k: n - before[k] for k, n in traverse_cuda.LAUNCHES.items() if n != before[k]}
        img_r, ms_r = _gate_image(torch, "reference", uri)
        diff = np.abs(img_k - img_r)
        res = {"mad_u8": float(diff.mean()), "max_u8": float(diff.max()),
               "frac_px_off_by_more_than_2": float((diff.max(axis=-1) > 2).mean()),
               "cuda_ms": ms_k, "reference_ms": ms_r, "cuda_launches": launched,
               "image_mean": float(img_r.mean())}
        log(f"[reference] image gate {uri} {GATE_W}x{GATE_H} 1 spp, cuda vs reference: {json.dumps(res)}")
        if not res["mad_u8"] < 1.0 or not img_r.max() > 0:
            raise AssertionError(f"the cuda image of {uri} is off the reference's: {res}")
        if set(launched) != kernels:
            raise AssertionError(f"the cuda gate frame of {uri} launched {launched}, expected {kernels}")
        out["gate"][uri] = res

    scene, flat, meta = _scene_tables(torch, HALL_SCENE)
    bvh_closest, bvh_any = trace_bvh.make_trace_fns(meta, stream=False, blas=flat.blas, slotlane=True)
    bf_closest, bf_any = trace_bruteforce.make_trace_fns(meta)
    orig, dirs, active = _primary_wavefront(torch, scene, ORACLE_W, ORACLE_H)
    R = orig.shape[0]
    out["oracle"] = {"scene": HALL_SCENE, "tris": meta.num_tris, "rays": R, "max_pairs": MAX_PAIRS}
    for wave in ("primary", "bounce"):
        t_min = 0.0 if wave == "primary" else EPSILON
        before = dict(traverse_cuda.LAUNCHES)
        k = bvh_closest(flat, orig, dirs, t_min, active)
        ref, secs, peak = _oracle_call(torch, bf_closest, flat, orig, dirs, t_min, active)
        res = {"active": int(active.sum()), "hits": int(ref.hit.sum()), "closest_s": secs,
               "closest_peak_bytes": peak,
               **_closest_agreement(tuple(k), tuple(ref), unified=False)}
        beyond = torch.arange(R, device="cuda") % 2 == 1
        t_max = torch.where(ref.t < 1e19, ref.t * torch.where(beyond, 0.999, 1.001),
                            torch.full_like(ref.t, 100.0))
        occ_k = bvh_any(flat, orig, dirs, t_max, active)
        occ_r, secs, peak = _oracle_call(torch, bf_any, flat, orig, dirs, t_max, active)
        launched = {k: n - before[k] for k, n in traverse_cuda.LAUNCHES.items() if n != before[k]}
        occ = _any_agreement(occ_k, occ_r)
        res.update(any_s=secs, any_peak_bytes=peak,
                   hits_to_1_001=int((ref.hit & ~beyond).sum()),
                   occluded_to_1_001=int((occ_r & ~beyond).sum()),
                   hits_to_0_999=int((ref.hit & beyond).sum()),
                   occluded_to_0_999=int((occ_r & beyond).sum()),
                   occ_mismatch=occ["occ_mismatch"], launches=launched,
                   ok=res["ok"] and occ["ok"])
        log(f"[reference] oracle vs B1/B2 on the hall, {wave} {ORACLE_W}x{ORACLE_H}: {json.dumps(res)}")
        if not res["ok"] or launched != {"closest": 1, "any": 1}:
            raise AssertionError(f"B1/B2 disagree with the brute-force oracle on the {wave} rays, or "
                                 f"did not run: {res}")
        out["oracle"][wave] = res
        if wave == "primary":
            orig, dirs, active = _bounce_wavefront(torch, flat, orig, dirs, ref.t, ref.tri, None)

    scene = _load(HALL_IMAGE)
    view = _view(scene)
    b = get_backend("reference")
    b.initialize(GATE_W, GATE_H)
    b.set_scene(scene)
    ms = [b.render(*view, i == 0, readback_framebuffer=False).render_time
          for i in range(1 + REFERENCE_FRAMES)][1:]
    out["reference_ms_per_frame"] = {"scene": HALL_IMAGE, "width": GATE_W, "height": GATE_H,
                                     "ms": ms, "median_ms": statistics.median(ms)}
    log(f"[reference] reference backend {HALL_IMAGE} {GATE_W}x{GATE_H} 1 spp: "
        f"{json.dumps(out['reference_ms_per_frame'])}")
    return out


def _cli_start(args, env=None):
    """python -m chameleonrt_tpu_torch.cli with args, started from the
    repository root, with env (if given) added to the environment."""
    return subprocess.Popen([sys.executable, "-m", "chameleonrt_tpu_torch.cli", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=None if env is None else {**os.environ, **env})


def _cli_end(proc, timeout=300):
    """The stdout of a _cli_start process, or an error with the end of its
    output; a process that outlasts timeout is killed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(proc.args[3:])} exited {proc.returncode}: "
                             f"{out[-2000:]}\n{err[-2000:]}")
    return out


def _cli(args, timeout=300):
    return _cli_end(_cli_start(args), timeout)


def phase_cli(torch, tmp):
    """The port's command line on the card, in processes of its own, each
    of which must exit 0 and write its files: the cuda backend on
    proc://cornell at 256x256 and 2 spp for 3 frames with -validation and
    -checkpoint, then resumed from that checkpoint for 2 more frames under
    -profile (the frame count goes on at 3, the new checkpoint holds 5, the
    trace names the traversal kernels B1/B2), and, beside these two, the
    reference backend with -benchmark-frames 2 at 64x64."""
    import numpy as np

    from chameleonrt_tpu_torch.cli import PROFILE_TRACE

    def check_state(path, frame_id):
        with np.load(path) as z:
            if int(z["frame_id"]) != frame_id or z["accum"].shape != (256, 256, 3):
                raise AssertionError(f"{path} holds frame {int(z['frame_id'])}, shape "
                                     f"{z['accum'].shape}, expected {frame_id}, (256, 256, 3)")

    t0 = time.perf_counter()
    # the reference run needs nothing of the other two, so it runs beside them
    ref_run = _cli_start(["reference", "proc://cornell", "-img", "64", "64", "-benchmark-frames",
                          "2", "-o", os.path.join(tmp, "r.png")])
    try:
        common = ["cuda", "proc://cornell", "-img", "256", "256", "-spp", "2", "-display", "none"]
        first, second = os.path.join(tmp, "s.npz"), os.path.join(tmp, "s2.npz")
        stdout = _cli([*common, "-frames", "3", "-validation", os.path.join(tmp, "v_"),
                       "-checkpoint", first, "-o", os.path.join(tmp, "a.png")])
        t1 = time.perf_counter()
        missing = [f for f in [f"v_cuda-f{i}.png" for i in range(3)] + ["a.png", "s.npz"]
                   if not os.path.isfile(os.path.join(tmp, f))]
        if missing or "Device: " not in stdout:
            raise AssertionError(f"the cuda run wrote no {missing}: {stdout[-1000:]}")
        check_state(first, 3)
        prof = os.path.join(tmp, "prof")
        stdout = _cli([*common, "-frames", "2", "-resume", first, "-checkpoint", second,
                       "-profile", prof, "-o", os.path.join(tmp, "b.png")])
        t2 = time.perf_counter()
        if f"Resumed from {first} at frame 3" not in stdout:
            raise AssertionError(f"the resumed run did not start at frame 3: {stdout[-1000:]}")
        check_state(second, 5)
        # every "name" in the trace (events' and their args'), read from the
        # text: parsing the whole JSON of a trace of ~150 MB takes seconds
        with open(os.path.join(prof, PROFILE_TRACE)) as f:
            names = set(re.findall(r'"name": "((?:[^"\\]|\\.)*)"', f.read()))
        kernels = sorted({m.group(1) for n in names for m in [_TRAVERSAL_KERNEL.search(n)] if m})
        if kernels != ["any", "closest"]:
            raise AssertionError(f"the profile's trace names the traversal kernels {kernels}, "
                                 "expected B1/B2 (any, closest)")
        t3 = time.perf_counter()
        stdout = _cli_end(ref_run)
    finally:
        if ref_run.poll() is None:
            ref_run.kill()
            ref_run.communicate()
    if not os.path.isfile(os.path.join(tmp, "r.png")) or "Avg render time" not in stdout:
        raise AssertionError(f"the reference run wrote no image or summary: {stdout[-1000:]}")
    t4 = time.perf_counter()
    res = {"seconds": t4 - t0, "cuda_s": t1 - t0, "cuda_resumed_profile_s": t2 - t1,
           "trace_read_s": t3 - t2, "reference_wait_s": t4 - t3, "trace_kernels": kernels,
           "trace_bytes": os.path.getsize(os.path.join(prof, PROFILE_TRACE)),
           "reference_summary": [ln for ln in stdout.splitlines() if ln.startswith("Avg")]}
    log(f"[cli] {json.dumps(res)}")
    return res


def phase_bench(torch):
    """The port's bench, `python3 -m chameleonrt_tpu_torch.bench`, in a
    process of its own (killed past BENCH_TIMEOUT_S): it must exit 0 and
    print as its last line one JSON object with bench.py's keys, its
    parity gate passed (kernels against the plain walk on the flat and
    two-level parity scenes, the `cuda` image against the `reference`
    one), and every one of the six configs a dict with mrays_per_s > 0.
    The line is logged whole."""
    from chameleonrt_tpu_torch.bench import CONFIGS

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "chameleonrt_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}: {proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    log(f"[bench] {json.dumps(line)}")
    log(f"[bench] the process took {secs:.1f} s; stderr ends: {proc.stderr[-500:]!r}")
    if set(line) != {"metric", "value", "unit", "vs_baseline", "detail"}:
        raise AssertionError(f"the bench's last line has the keys {sorted(line)}")
    parity = line["detail"].get("parity", {})
    if parity.get("ok") is not True:
        raise AssertionError(f"the bench's parity gate failed: {parity}")
    configs = line["detail"]["configs"]
    bad = {name: configs.get(name) for name, *_ in CONFIGS
           if not (isinstance(configs.get(name), dict) and configs[name]["mrays_per_s"] > 0)}
    if bad:
        raise AssertionError(f"bench configs failed or skipped: {bad}")
    return {"seconds": secs, "line": line}


def phase_lbvh(torch, tmp):
    """The LBVH fallback on the card (what a host with no C++ compiler
    runs):
    - the LBVH of the main path's hall (224,768 triangles) and the
      per-mesh LBVHs of proc://instances?nx=4&ny=4&subdiv=2 built on the
      card, timed (LBVH_BUILD_REPS builds after one warmup);
    - on the hall's sorted 1280x720 primary wavefront, B1 and B2 over the
      LBVH's binary table (its certified height + 1 entries of stack)
      against their plain versions over it, exactly (B2 to 1.001 of the
      native table's hit, 100 on a miss), each timed beside B1/B2 over the
      native BVH4 table; and B1/B2 over the LBVH against B1/B2 over the
      native table on the JAX bench's gate: prim and occlusion mismatches
      <= max(2, R / 50000), |dt| <= 1e-5 over common hits, lanes at -2
      logged;
    - get_backend("cuda") in this process with native.get_lib patched to
      None (as on a host with no compiler): two 128x72 frames at 1 spp of
      the textured hall and of the 4x4 grid, every launch count set to 0
      just before each and read just after: B1/B2 5 + 10 a frame, one
      launch of each per instance of the grid, all on the 64-entry stack;
    - python -m chameleonrt_tpu_torch.cli cuda on the textured hall and on
      the 4x4 grid at 128x72, 2 frames, in processes whose CXX names no
      compiler (the LBVH path, its backend's name says so) and in processes
      with the native builder, all four at once: each LBVH image against
      the native one, 8-bit MAD < 1.0."""
    import numpy as np

    from chameleonrt_tpu_torch import native as native_lib
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.engine import trace_bvh
    from chameleonrt_tpu_torch.ops import lbvh, traverse_cuda
    from chameleonrt_tpu_torch.ops import traverse as plain
    from chameleonrt_tpu_torch.utils.png import read_png

    t_start = time.perf_counter()
    # CLI renders first: they run beside the checks below
    jobs = {}
    for uri in (HALL_IMAGE, INST_PARITY):
        for kind, env in (("native", None), ("lbvh", {"CXX": NO_COMPILER})):
            png = os.path.join(tmp, f"lbvh_{kind}_{len(jobs)}.png")
            jobs[uri, kind] = (_cli_start(["cuda", uri, "-img", str(GATE_W), str(GATE_H), "-frames",
                                           "2", "-display", "none", "-o", png], env=env), png)
    try:
        def timed(fn):
            """(result, seconds of each build after one warmup)"""
            secs = []
            for _ in range(1 + LBVH_BUILD_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return out, secs[1:]

        scene, flat, meta = _scene_tables(torch, HALL_SCENE)
        mesh = meta.inst_mesh[0]
        start, count = meta.mesh_tri_ranges[mesh]
        sl = slice(start, start + count)
        table, hall_s = timed(lambda: lbvh.build_packed(flat.tri_v0[sl], flat.tri_e1[sl],
                                                        flat.tri_e2[sl]))
        _, gflat, gmeta = _scene_tables(torch, INST_PARITY)
        grid, grid_s = timed(lambda: trace_bvh._lbvh_blas_set(gflat, gmeta))
        depth = traverse_cuda.stack_depth(table)
        res = {"hall": {"tris": count, "node_rows": int(table.nodes.shape[0]),
                        "leaf_rows": int(table.leaf_rows.shape[0]),
                        "bytes": trace_bvh.table_bytes(table), "height": table.max_depth,
                        "stack": depth, "stack_capacity": traverse_cuda.stack_capacity(depth),
                        "build_s": hall_s, "build_s_median": statistics.median(hall_s)},
               "grid": {"meshes": len(grid), "instances": gmeta.num_instances,
                        "tris": gmeta.num_tris, "bytes": sum(trace_bvh.table_bytes(p.closest)
                                                            for p in grid),
                        "heights": [p.closest.max_depth for p in grid],
                        "build_s": grid_s, "build_s_median": statistics.median(grid_s)}}
        ids = table.leaf_rows[:, 9 * 4 : 10 * 4].contiguous().view(torch.int32)
        if not torch.equal(ids[ids >= 0].sort().values.cpu(), torch.arange(count, dtype=torch.int32)):
            raise AssertionError("the hall's LBVH does not hold each triangle once")

        orig, dirs, active = _primary_wavefront(torch, scene, MAIN_W, MAIN_H)
        R = orig.shape[0]
        native = flat.blas[mesh].any
        tmin = torch.zeros(R, dtype=torch.float32, device="cuda")
        tinf = torch.full((R,), 1e20, dtype=torch.float32, device="cuda")
        eps = torch.full((R,), 1e-4, dtype=torch.float32, device="cuda")
        closest_args = (orig, dirs, tmin, active, tinf)
        kn = traverse_cuda.traverse_closest(native, *closest_args)
        tmax = torch.where(kn[1] >= 0, kn[0] * 1.001, torch.full_like(kn[0], 100.0))
        any_args = (orig, dirs, eps, tmax, active)
        kl = traverse_cuda.traverse_closest(table, *closest_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = plain.traverse_closest(table, *closest_args)
        torch.cuda.synchronize()
        plain_closest_s = time.perf_counter() - t0
        ok_l = traverse_cuda.traverse_any(table, *any_args)
        ok_n = traverse_cuda.traverse_any(native, *any_args)
        t0 = time.perf_counter()
        ol = plain.traverse_any(table, *any_args)
        torch.cuda.synchronize()
        plain_any_s = time.perf_counter() - t0
        exact = {"closest": _closest_agreement(kl, pl, False, exact=True),
                 "any": _any_agreement(ok_l, ol, exact=True),
                 "plain_closest_s": plain_closest_s, "plain_any_s": plain_any_s}
        ms = {name: _median_ms(torch, fn, 5) for name, fn in (
            ("B1_lbvh", lambda: traverse_cuda.traverse_closest(table, *closest_args)),
            ("B1_native", lambda: traverse_cuda.traverse_closest(native, *closest_args)),
            ("B2_lbvh", lambda: traverse_cuda.traverse_any(table, *any_args)),
            ("B2_native", lambda: traverse_cuda.traverse_any(native, *any_args)))}
        closest_gate = _closest_agreement(kl, kn, False)
        any_gate = _any_agreement(ok_l, ok_n)
        gate = {"rays": R, **closest_gate, **any_gate, "ok": closest_gate["ok"] and any_gate["ok"],
                "overflow_lanes": int((kl[1] == -2).sum()), "hits": int((kl[1] >= 0).sum()),
                "occluded": int(ok_l.sum())}
        res["hall"].update(kernels_vs_plain=exact, kernel_ms=ms, lbvh_vs_native=gate)
        log(f"[lbvh] builds on the card, B1/B2 over the hall's LBVH against the plain walk over "
            f"it and against B1/B2 over its native table: {json.dumps(res)}")
        if gate["overflow_lanes"]:
            log(f"[lbvh] {gate['overflow_lanes']} lanes of the hall's primary wavefront overflowed "
                f"B1's {depth}-entry stack over the LBVH (prim -2)")
        if not (exact["closest"]["ok"] and exact["any"]["ok"]):
            raise AssertionError(f"B1/B2 over the LBVH differ from the plain walk: {exact}")
        if not gate["ok"]:
            raise AssertionError(f"B1/B2 over the LBVH fail the bench's gate against the native "
                                 f"table: {gate}")

        # the LBVH path in this process: the tables of a host with no compiler
        real_get_lib = native_lib.get_lib
        native_lib.get_lib = lambda: None
        try:
            frames = {}
            for uri, per_frame in ((HALL_IMAGE, 1), (INST_PARITY, gmeta.num_instances)):
                for k in traverse_cuda.LAUNCHES:
                    traverse_cuda.LAUNCHES[k] = 0
                    for cap in traverse_cuda.STACK_LAUNCHES[k]:
                        traverse_cuda.STACK_LAUNCHES[k][cap] = 0
                view_scene = _load(uri)
                pos, d, up, fov = _view(view_scene)
                b = get_backend("cuda")
                b.initialize(GATE_W, GATE_H)
                b.set_scene(view_scene)
                b.samples_per_pixel = 1
                for i in range(2):
                    b.render(pos, d, up, fov, i == 0, readback_framebuffer=(i == 1))
                torch.cuda.synchronize()
                launches = {k: n for k, n in traverse_cuda.LAUNCHES.items() if n}
                stacks = {k: {cap: n for cap, n in caps.items() if n}
                          for k, caps in traverse_cuda.STACK_LAUNCHES.items() if any(caps.values())}
                want = {"closest": 2 * 5 * per_frame, "any": 2 * 10 * per_frame}
                frames[uri] = {"launches": launches, "stack_launches": stacks,
                               "heights": [p.closest.max_depth for p in b.flat.blas],
                               "image_mean": float(b.img[..., :3].mean())}
                if launches != want or stacks != {k: {64: n} for k, n in want.items()}:
                    raise AssertionError(f"the LBVH path on {uri} launched {launches} by stack "
                                         f"{stacks}, expected {want}, all on the 64-entry stack")
        finally:
            native_lib.get_lib = real_get_lib
        res["frames"] = frames
        log(f"[lbvh] get_backend('cuda') with no native builder, {GATE_W}x{GATE_H} x2 frames at "
            f"1 spp: {json.dumps(frames)}")

        images = {}
        for (uri, kind), (proc, png) in jobs.items():
            stdout = _cli_end(proc)
            want = "(LBVH" if kind == "lbvh" else "(SAH BVH4)"
            if f"Backend: CUDA wavefront {want}" not in stdout:
                raise AssertionError(f"the {kind} cli run of {uri} ran another backend: "
                                     f"{stdout[-1000:]}")
            images[uri, kind] = read_png(png)[..., :3].astype(np.float32)
    finally:
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    res["images"] = {}
    for uri in (HALL_IMAGE, INST_PARITY):
        diff = np.abs(images[uri, "lbvh"] - images[uri, "native"])
        res["images"][uri] = {"mad": float(diff.mean()), "max": float(diff.max()),
                              "image_mean": float(images[uri, "lbvh"].mean())}
    res["seconds"] = time.perf_counter() - t_start
    log(f"[lbvh] cli cuda {GATE_W}x{GATE_H} x2 frames, CXX={NO_COMPILER} (LBVH) against the "
        f"native builder's: {json.dumps(res['images'])}; phase {res['seconds']:.1f} s")
    for uri, r in res["images"].items():
        if not (r["mad"] < 1.0 and r["image_mean"] > 0):
            raise AssertionError(f"the LBVH image of {uri} differs from the native one: {r}")
    return res


# a traversal kernel's name, mangled (...29closest_unified_stream_kernelE...)
# or not ((anonymous namespace)::closest_unified_stream_kernel(float const*,
# ...); the group is its launch-count key
_TRAVERSAL_KERNEL = re.compile(
    r"(?<![a-z_])((?:closest|any)(?:_unified)?(?:_stream|_persistent|_packet)?)_kernel(?![a-z_])")


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _profile_frames(torch, backend, view, median_ms, expect):
    """Where a main path's frame time goes: PROFILE_FRAMES more frames
    under torch.profiler (device-side events only). Per frame: the device
    busy time (the union of the events' intervals) and the idle share of
    the median unprofiled frame, the traversal kernels' device time and
    launches, and the largest other rows. The profiler slows the host, so
    busy time is set against unprofiled frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FRAMES):
            backend.render(*view, False, readback_framebuffer=False)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rows = {}
    for e in events:
        m = _TRAVERSAL_KERNEL.search(e.name)
        key = m.group(1) if m else e.name[:100]
        n, us = rows.get(key, (0, 0.0))
        rows[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / PROFILE_FRAMES
    per_frame = {k: (n / PROFILE_FRAMES, us / 1e3 / PROFILE_FRAMES) for k, (n, us) in rows.items()}
    traversal = {k: per_frame.pop(k, (0, 0.0)) for k in expect}
    res = {
        "profiled_frames": PROFILE_FRAMES,
        "device_events_per_frame": len(events) / PROFILE_FRAMES, "busy_ms_per_frame": busy,
        "idle_share": 1.0 - busy / median_ms,
        "traversal_per_frame": {k: {"launches": n, "ms": t} for k, (n, t) in traversal.items()},
        "traversal_share_of_busy": sum(t for _, t in traversal.values()) / busy,
        "largest_other_rows_per_frame": [
            {"name": k, "launches": n, "ms": t}
            for k, (n, t) in sorted(per_frame.items(), key=lambda kv: -kv[1][1])[:6]],
    }
    # at ~76K device events a frame the profiler may miss a few, so the
    # launch counts per frame come from the counters; here each of the
    # path's kernels must show up
    if not all(traversal[k][0] > 0 for k in expect):
        names = [k for k in per_frame if "at::native" not in k][:10]
        raise AssertionError(f"the profile saw {traversal}, expected {expect} per frame; "
                             f"rows outside at::native: {names}")
    return res


def phase_main(torch, uri, W, H, spp, timed_frames, expect, slotlane=True, grid_packet=False):
    """get_backend("cuda", slotlane=slotlane, grid_packet=grid_packet) on
    uri at W x H and spp
    samples per pixel (set after set_scene, as bench.py does): one warmup,
    timed_frames frames timed on the host clock and PROFILE_FRAMES profiled frames
    (_profile_frames), with every launch count set to 0 just before and
    read just after. expect maps each count to its launches per frame.
    Returns {count: (launches in the run, launches per frame, {stack
    capacity: launches})} of the traversal kernels that ran, S1's under
    "shade_bounce" and R1-R3's under "sort" (their stack capacities None)."""
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.engine import trace_bvh
    from chameleonrt_tpu_torch.ops import shade_cuda, sort_cuda, traverse_cuda

    scene = _load(uri)
    pos, d, up, fov = _view(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    _zero_launches()
    backend = get_backend("cuda", slotlane=slotlane, grid_packet=grid_packet)
    backend.initialize(W, H)
    t0 = time.perf_counter()
    backend.set_scene(scene)
    set_scene_s = time.perf_counter() - t0
    backend.samples_per_pixel = spp
    stats = []
    n_frames = 1 + timed_frames
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = backend.render(pos, d, up, fov, i == 0, readback_framebuffer=(i == n_frames - 1))
        torch.cuda.synchronize()
        stats.append((time.perf_counter() - t0, st))
    timed = stats[1:]
    ms = [s * 1e3 for s, _ in timed]
    rays = [st.rays_traced for _, st in timed]
    mray_s = [r / s / 1e6 for (s, _), r in zip(timed, rays)]
    peak = torch.cuda.max_memory_allocated()
    profiled = _profile_frames(torch, backend, (pos, d, up, fov), statistics.median(ms), expect)
    n_frames += PROFILE_FRAMES
    launches = dict(traverse_cuda.LAUNCHES)
    shade_launches = shade_cuda.LAUNCHES
    sort_launches = sort_cuda.LAUNCHES
    stacks = {k: {cap: n for cap, n in caps.items() if n}
              for k, caps in traverse_cuda.STACK_LAUNCHES.items() if any(caps.values())}
    # the table the path's kernels traced (both hit kinds: the wide one, or
    # the binary one with grid_packet)
    pair = backend.flat.blas[0 if backend.meta.num_instances > 1 else backend.meta.inst_mesh[0]]
    table = pair.closest if grid_packet else pair.any
    depth = traverse_cuda.stack_depth(table)
    table_res = {"arity": table.arity, "node_rows": int(table.nodes.shape[0]),
                 "leaf_rows": int(table.leaf_rows.shape[0]), "bytes": trace_bvh.table_bytes(table),
                 "stack": depth, "stack_capacity": traverse_cuda.stack_capacity(depth),
                 "beyond_l2": trace_bvh.streamed_tier(table)}
    res = {
        "scene": uri, "width": W, "height": H, "spp": spp, "slotlane": slotlane,
        "grid_packet": grid_packet,
        "unique_tris": backend.meta.num_tris, "instances": backend.meta.num_instances,
        "instanced_tris": scene.total_tris(),
        "set_scene_s": set_scene_s, "warmup_ms": stats[0][0] * 1e3,
        "ms_per_frame": ms, "min_ms": min(ms), "median_ms": statistics.median(ms),
        "rays_per_frame": rays, "mray_s_median": statistics.median(mray_s),
        "peak_mem_bytes": peak, "allocated_before_bytes": allocated_before,
        "launches": launches, "shade_launches": shade_launches, "sort_launches": sort_launches,
        "stack_launches": stacks,
        "frames": n_frames, "table": table_res,
    }
    log(f"[main] {json.dumps(res)}")
    log(f"[profile] {uri}: {json.dumps(profiled)}")
    want = {k: expect.get(k, 0) * n_frames for k in launches}
    if launches != want:
        raise AssertionError(f"expected {want} launches over {n_frames} frames, got {launches}")
    # S1 shades every bounce's live lanes, once a sample
    if shade_launches != 5 * spp * n_frames:
        raise AssertionError(f"expected {5 * spp * n_frames} S1 launches over {n_frames} frames, "
                             f"got {shade_launches}")
    # R1-R3 re-sort every bounce's wavefront, once a sample
    if sort_launches != 3 * 5 * spp * n_frames:
        raise AssertionError(f"expected {3 * 5 * spp * n_frames} R1-R3 launches over {n_frames} "
                             f"frames, got {sort_launches}")
    # the BVH4 tables and the hall's binary one keep the 64-entry stacks
    want_cap = {k: {64: n} for k, n in launches.items() if n}
    if stacks != want_cap:
        raise AssertionError(f"expected launches by stack capacity {want_cap}, got {stacks}")
    accum = backend._accum
    if tuple(accum.shape) != (H, W, 3) or not bool(torch.isfinite(accum).all()):
        raise AssertionError("accumulated image is not a finite (H, W, 3) buffer")
    if not float(accum.max()) > 0.0 or int(backend.img[..., :3].max()) == 0:
        raise AssertionError("accumulated image is all black")
    log(f"[main] {uri}: image mean {float(accum.mean()):.5f}, max {float(accum.max()):.5f}; "
        f"8-bit image mean {float(backend.img[..., :3].mean()):.3f}")
    return {**{k: (n, n // n_frames, stacks[k]) for k, n in launches.items() if n},
            "shade_bounce": (shade_launches, shade_launches // n_frames, None),
            "sort": (sort_launches, sort_launches // n_frames, None)}


def _main_paths():
    """Each main path: (scene, width, height, spp, timed frames, launches
    per frame by launch-count key); the work-queue paths (QUEUE's values)
    run with the slot-lane tier off, the grid_packet path with
    grid_packet=True."""
    return {
        "flat": (HALL_SCENE, MAIN_W, MAIN_H, 1, HALL_TIMED_FRAMES, {"closest": 5, "any": 10}),
        "unified": (SAN_MIGUEL, MAIN_W, MAIN_H, SM_SPP, SM_TIMED_FRAMES,
                    {"closest_unified": 5 * SM_SPP, "any_unified": 10 * SM_SPP}),
        "stream": (CITY_SCENE, CITY_W, CITY_H, 1, CITY_TIMED_FRAMES,
                   {"closest_stream": 5, "any_stream": 10}),
        "unified_stream": (SAN_MIGUEL_LARGE, MAIN_W, MAIN_H, SM_SPP, LARGE_TIMED_FRAMES,
                           {"closest_unified_stream": 5 * SM_SPP,
                            "any_unified_stream": 10 * SM_SPP}),
        "persistent": (HALL_SCENE, MAIN_W, MAIN_H, 1, HALL_TIMED_FRAMES,
                       {"closest_persistent": 5, "any_persistent": 10}),
        "unified_persistent": (SAN_MIGUEL, MAIN_W, MAIN_H, SM_SPP, SM_TIMED_FRAMES,
                               {"closest_unified_persistent": 5 * SM_SPP,
                                "any_unified_persistent": 10 * SM_SPP}),
        "grid_packet": (HALL_SCENE, MAIN_W, MAIN_H, 1, HALL_TIMED_FRAMES,
                        {"closest_packet": 5, "any_packet": 10}),
    }


def _bench_paths():
    """The port's bench configs that no main path runs, as main paths of
    their own, each at its scene, size and spp (bench.CONFIGS), with the
    slot-lane tier on: cornell (B1/B2), the 36-instance grid (B3/B4) and
    the 6.7M-triangle soup, whose table exceeds the L2 (B5a/B5b). Same
    tuples as _main_paths; the kernels' launch counts in the kernels line
    stay those of _main_paths."""
    from chameleonrt_tpu_torch.bench import CONFIGS

    bench = {name: (url, w, h, spp) for name, url, w, h, _, spp in CONFIGS}
    return {path: (*bench[BENCH_PATHS[path]], BENCH_PATH_TIMED_FRAMES,
                   {f"closest{key}": 5, f"any{key}": 10})
            for path, key in (("cornell", ""), ("instanced", "_unified"), ("soup", "_stream"))}


def _zero_launches():
    """Every kernel's launch counts, in all and by stack capacity, set to 0."""
    from chameleonrt_tpu_torch.ops import shade_cuda, sort_cuda, traverse_cuda

    shade_cuda.LAUNCHES = 0
    sort_cuda.LAUNCHES = 0
    for k in traverse_cuda.LAUNCHES:
        traverse_cuda.LAUNCHES[k] = 0
        for cap in traverse_cuda.STACK_LAUNCHES[k]:
            traverse_cuda.STACK_LAUNCHES[k][cap] = 0


def _sharded_run(torch, scene, devices, rebalance):
    """get_backend("cuda", devices=devices, rebalance=rebalance) on scene
    at MAIN_W x MAIN_H, 1 spp, for SHARDED_FRAMES progressive frames,
    each read back, with the launch counts set to 0 just before the frames
    and read just after. Returns (per frame: (ms, rays, lanes moved, sRGB8
    image, accumulator); {count: launches})."""
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    pos, d, up, fov = _view(scene)
    backend = get_backend("cuda", devices=devices, rebalance=rebalance)
    backend.initialize(MAIN_W, MAIN_H)
    backend.set_scene(scene)
    backend.samples_per_pixel = 1
    frames = []
    _zero_launches()
    for i in range(SHARDED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = backend.render(pos, d, up, fov, i == 0)
        torch.cuda.synchronize()
        frames.append(((time.perf_counter() - t0) * 1e3, st.rays_traced,
                       backend._step.lanes_moved if backend._step else 0, backend.img.copy(),
                       backend.framebuffer().clone()))
    return frames, {k: n for k, n in traverse_cuda.LAUNCHES.items() if n}


def phase_sharded(torch, smi, tmp):
    """Multi-device rendering (parallel/sharded.py) with N shards on cuda:0:
    the textured hall with 4 and with 7 shards (720 rows pad to 721; B1/B2)
    and the bench's 36-instance grid with 4 (B3/B4), at 1280x720, 1 spp,
    each on one device, on N shards and on N shards rebalanced, for
    SHARDED_FRAMES progressive frames. Every frame's sRGB8 image must equal
    the one device's and its accumulator agree within DT_TOL, with equal
    rays; each run must launch its tier's kernels 5 + 10 times a shard a
    frame, and the rebalanced runs move lanes in every frame. Then the CLI
    with `-devices all -rebalance` (one device on a one-card host) must
    write the image of the same run without them."""
    import numpy as np

    from chameleonrt_tpu_torch.bench import CONFIGS
    from chameleonrt_tpu_torch.utils.image_io import read_image

    t0 = time.perf_counter()
    cli_args = ["cuda", "proc://cornell", "-img", "256", "256", "-frames", "2", "-display", "none"]
    runs = [_cli_start([*cli_args, *flags, "-o", os.path.join(tmp, name)])
            for name, flags in (("one.png", []), ("all.png", ["-devices", "all", "-rebalance"]))]
    try:
        grid = next(url for name, url, *_ in CONFIGS if name == "instanced")
        out = []
        singles = {}
        for label, uri, n, key in (("hall", HALL_SCENE, 4, ""), ("hall", HALL_SCENE, 7, ""),
                                   ("instanced", grid, 4, "_unified")):
            scene = _load(uri)
            if uri not in singles:
                singles[uri] = _sharded_run(torch, scene, 0, False)
            one, one_launches = singles[uri]
            res = {"scene": label, "uri": uri, "shards": n, "one_device": {
                "ms_per_frame": [f[0] for f in one], "rays_per_frame": [f[1] for f in one],
                "launches": one_launches}}
            for mode, rebalance in (("static", False), ("rebalanced", True)):
                frames, launches = _sharded_run(torch, scene, [torch.device("cuda", 0)] * n,
                                                rebalance)
                want = {f"closest{key}": 5 * n * SHARDED_FRAMES, f"any{key}": 10 * n * SHARDED_FRAMES}
                if launches != want:
                    raise AssertionError(f"{label}, {n} shards, {mode}: launches {launches}, "
                                         f"expected {want}")
                for i, (f, g) in enumerate(zip(frames, one)):
                    err = float((f[4] - g[4]).abs().max())
                    if not np.array_equal(f[3], g[3]) or err > DT_TOL or f[1] != g[1]:
                        raise AssertionError(
                            f"{label}, {n} shards, {mode}, frame {i}: sRGB8 equal "
                            f"{np.array_equal(f[3], g[3])}, accumulator max |diff| {err}, "
                            f"rays {f[1]} against {g[1]}")
                moved = [f[2] for f in frames]
                if rebalance and min(moved) <= 0:
                    raise AssertionError(f"{label}, {n} shards: the exchange moved {moved} lanes")
                res[mode] = {"ms_per_frame": [f[0] for f in frames],
                             "rays_per_frame": [f[1] for f in frames], "lanes_moved": moved,
                             "max_abs_err": max(float((f[4] - g[4]).abs().max())
                                                for f, g in zip(frames, one)),
                             "launches": launches}
            out.append(res)
            gc.collect()
        t1 = time.perf_counter()
        for proc in runs:
            _cli_end(proc)
    finally:
        for proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    one_img, all_img = (read_image(os.path.join(tmp, name)) for name in ("one.png", "all.png"))
    if not np.array_equal(one_img, all_img):
        raise AssertionError("the CLI's image with -devices all -rebalance differs from the one "
                             "without them")
    res = {"nvidia_smi": smi, "cases": out, "frames_s": t1 - t0, "cli_image_equal": True,
           "seconds": time.perf_counter() - t0}
    log(f"[sharded] {json.dumps(res)}")
    return out


def _foreign_modules():
    """Modules of JAX or of the JAX package that this process imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "chameleonrt_tpu"))


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "chameleonrt_tpu_torch")):
        print("chip_smoke.py must run from the repository root", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chameleonrt_tpu_torch._build import STACK_CAPACITIES

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_toolchain(torch)
    build_s, ptxas = phase_build()
    sres = phase_shade(torch)
    rres = phase_sort(torch)
    kres = {path: phase_kernels(torch, path) for path in TIERS}
    pres = phase_packet(torch)
    ares = phase_arities(torch)
    c3 = phase_bvh8(torch)
    grids = _queue_grids(torch)
    phase_image(torch, HALL_IMAGE)
    phase_image(torch, INST_IMAGE)
    phase_image(torch, CITY_PARITY, stream=True, expect={"closest_stream", "any_stream"})
    phase_image(torch, INST_IMAGE, stream=True,
                expect={"closest_unified_stream", "any_unified_stream"})
    phase_image(torch, HALL_IMAGE, slotlane=False, expect={"closest_persistent", "any_persistent"})
    phase_image(torch, INST_IMAGE, slotlane=False,
                expect={"closest_unified_persistent", "any_unified_persistent"})
    phase_image(torch, HALL_IMAGE, grid_packet=True, expect={"closest_packet", "any_packet"},
                tables=(16, 32, 40))
    # the JAX engine's table switches: closest hit on the binary table, BVH8
    # rows, leaves of 8 triangles (node and leaf row widths in floats)
    for switch, tables in ((("CHAMELEONRT_CLOSEST_ARITY", "2"), (16, 32, 40)),
                           (("CHAMELEONRT_WIDE_ARITY", "8"), (16, 64, 40)),
                           (("CHAMELEONRT_LEAF_SIZE", "8"), (16, 32, 80))):
        with _env(**dict([switch])):
            phase_image(torch, HALL_IMAGE, expect={"closest", "any"}, tables=tables)
            phase_image(torch, INST_IMAGE, expect={"closest_unified", "any_unified"}, tables=tables)
    t_new = time.perf_counter()
    phase_reference(torch)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(torch, tmp)
        log(f"[reference] phase_reference and phase_cli took {time.perf_counter() - t_new:.1f} s")
        phase_lbvh(torch, tmp)
    _TABLES.clear()  # the bench and the main paths build their own tables
    gc.collect()
    torch.cuda.empty_cache()
    phase_bench(torch)
    launches = {path: phase_main(torch, *args, slotlane=path not in QUEUE.values(),
                                 grid_packet=path == "grid_packet")
                for path, args in _main_paths().items()}
    for args in _bench_paths().values():
        phase_main(torch, *args)
    with tempfile.TemporaryDirectory() as tmp:
        phase_sharded(torch, smi, tmp)
    foreign = _foreign_modules()
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign}")

    def arities(label, count, err4):
        """An entry's worst error, times and ptxas counts at each arity
        (phase_arities; the entry's own error joins A = 4) and stack
        capacity."""
        out = {}
        for a in ARITIES:
            r = ares[label][a]
            ptx = {f"stack{cap}": ptxas[count, a, cap] for cap in STACK_CAPACITIES}
            out[str(a)] = {"max_abs_err": max(r["max_abs_err"], err4) if a == 4 else r["max_abs_err"],
                           "mismatch": r["mismatch"], "ms": r["ms"], **ptx}
        return out

    # C3: each kernel on its scene's BVH8 table
    bvh8 = {name: {"scene": label, "stack": res["stack"], **{
        k: v for k, v in r.items() if k in ("prim_mismatch", "occ_mismatch", "max_dt_common", "ms",
                                            "stack_launches")}}
        for label, res in c3["cases"].items() for name, r in res.items() if name[0] == "B"}

    def shared(path, count, primary, bounce):
        """The keys every phase-3 entry shares: launches on the main path
        and by stack capacity there, times, bounds on both wavefronts."""
        out = {"launches": launches[path][count][0], "launches_per_frame": launches[path][count][1],
               "main_path_stack_launches": launches[path][count][2],
               "ms": primary["ms"], "plain_ms": primary["plain_ms"],
               "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"], "library_ms": None,
               "bounce_ms": bounce["ms"], "bounce_plain_ms": bounce["plain_ms"],
               "bounce_bound_ms": bounce["bound_ms"], "bounce_bound_by": bounce["bound_by"]}
        if "ms_stack128" in primary:
            out.update(ms_stack128=primary["ms_stack128"], bounce_ms_stack128=bounce["ms_stack128"])
        return out

    def shadow(res):
        """An any-hit kernel on one main-path frame's 10 shadow wavefronts
        (_check_any_shadow): per call and summed, B2 on the same rays beside
        B5b and B7b."""
        return {k: res[k] for k in ("masked_in", "occluded", "occ_mismatch", "ms", "ms_sum",
                                    "bound_ms", "bound_ms_sum", "bound_by", "flat_ms",
                                    "flat_ms_sum") if k in res}

    def frame(res):
        """A flat closest-hit kernel on one main-path frame's 5 closest-hit
        wavefronts (_check_closest_frame): per call and summed, B1 on the
        same rays beside it."""
        return {k: res[k] for k in ("active", "prim_mismatch", "max_dt_common", "exact", "ms",
                                    "ms_sum", "flat_ms", "flat_ms_sum", "bound_ms",
                                    "bound_ms_sum", "bound_by")}

    kernels = []
    slotlane = "chameleonrt_tpu/ops/traverse_slotlane.py"
    for name, path, key, src, replaces in (
        ("B1 flat closest hit", "flat", "closest", "traverse_flat.cu",
         f"{slotlane}:771 (_closest_call_slotlane)"),
        ("B2 flat any hit", "flat", "any", "traverse_flat.cu",
         f"{slotlane}:835 (_any_call_slotlane)"),
        ("B3 two-level closest hit", "unified", "closest", "traverse_unified.cu",
         f"{slotlane}:1025 (_closest_unified_call_slotlane)"),
        ("B4 two-level any hit", "unified", "any", "traverse_unified.cu",
         f"{slotlane}:1085 (_any_unified_call_slotlane)"),
        ("B5a flat closest hit, streamed tier", "stream", "closest", "traverse_stream.cu",
         f"{slotlane}:771 (_closest_call_slotlane, stream=True)"),
        ("B5b flat any hit, streamed tier", "stream", "any", "traverse_stream.cu",
         f"{slotlane}:835 (_any_call_slotlane, stream=True)"),
        ("B5c two-level closest hit, streamed tier", "unified_stream", "closest",
         "traverse_unified_stream.cu",
         f"{slotlane}:1025 (_closest_unified_call_slotlane, stream=True)"),
        ("B5d two-level any hit, streamed tier", "unified_stream", "any",
         "traverse_unified_stream.cu", f"{slotlane}:1085 (_any_unified_call_slotlane, stream=True)"),
    ):
        primary, bounce = kres[path][key]
        checked = (primary, bounce) if key == "closest" else kres[path]["any_all"]
        err = max(r.get("max_dt_common", r.get("max_abs_err")) for r in checked)
        if key == "any":
            err = max(err, float(kres[path]["shadow"]["occ_mismatch"] > 0))
        count = key if path == "flat" else f"{key}_{path}"
        label = name.split()[0]
        entry = {
            "name": name, "route": "cuda", "source": f"chameleonrt_tpu_torch/csrc/{src}",
            "replaces": replaces, "max_abs_err": err, **shared(path, count, primary, bounce),
            "stack_capacities": list(STACK_CAPACITIES),
            "arities": arities(label, count, err),
        }
        if label in bvh8:
            entry["bvh8"] = bvh8[label]
        if key == "any":
            entry["shadow"] = shadow(kres[path]["shadow"])
        if key == "closest" and path in _CLOSEST_FRAME:
            entry["main_path_frame"] = frame(kres[path]["frame"])
        if path in SAME_RAYS:  # the unstreamed kernels on the same wavefronts
            other = SAME_RAYS[path]
            entry[f"{other}_kernel_ms"] = primary[f"{other}_ms"]
            entry[f"{other}_kernel_bounce_ms"] = bounce[f"{other}_ms"]
        kernels.append(entry)
    # the work-queue kernels ran on the wavefronts of two tiers each: the
    # first tier's main-path wavefronts give the entry's times and bound
    # (the same function on the same rays as that tier's kernel), the
    # second's go under "<tier>_wavefronts"; each carries the tier kernels'
    # times on the same rays
    packet = "chameleonrt_tpu/ops/traverse_packet.py"
    for name, qpath, key, tiers, replaces in (
        ("B6a flat closest hit, work queue", "persistent", "closest", ("flat", "stream"),
         f"{packet}:2029 (_closest_call_persistent, stream False and True)"),
        ("B6b flat any hit, work queue", "persistent", "any", ("flat", "stream"),
         f"{packet}:2110 (_any_call_persistent, stream False and True)"),
        ("B6c two-level closest hit, work queue", "unified_persistent", "closest",
         ("unified", "unified_stream"),
         f"{packet}:1785 (_closest_unified_call_persistent, stream False and True)"),
        ("B6d two-level any hit, work queue", "unified_persistent", "any",
         ("unified", "unified_stream"),
         f"{packet}:1849 (_any_unified_call_persistent, stream False and True)"),
    ):
        label = name.split()[0]
        err_key = "max_dt_common" if key == "closest" else "max_abs_err"
        errs = [r[err_key] for tier in tiers for q in kres[tier]["queue_all"][key] for r in (q, q["small"])]
        if key == "any":
            errs.append(float(kres[tiers[0]]["queue_shadow"]["occ_mismatch"] > 0))
        count = f"{key}_{qpath}"
        entry = {
            "name": name, "route": "cuda", "source": "chameleonrt_tpu_torch/csrc/traverse_persistent.cu",
            "replaces": replaces, "launches": launches[qpath][count][0],
            "launches_per_frame": launches[qpath][count][1],
            "main_path_stack_launches": launches[qpath][count][2], "max_abs_err": max(errs),
            "stack_capacities": list(STACK_CAPACITIES), "resident_blocks": grids[label],
            "arities": arities(label, count, max(errs)),
        }
        if label in bvh8:
            entry["bvh8"] = bvh8[label]
        if key == "closest" and tiers[0] == "flat":  # beside B1 on its frame's rays
            entry["main_path_frame"] = frame(kres["flat"]["queue_frame"])
        if key == "any":  # beside the tier kernel's times on its frame's rays
            queue_shadow, tier_shadow = kres[tiers[0]]["queue_shadow"], kres[tiers[0]]["shadow"]
            entry["shadow"] = {**shadow(queue_shadow), "same_rays": queue_shadow["same_rays"],
                               f"{tiers[0]}_kernel_ms": tier_shadow["ms"],
                               f"{tiers[0]}_kernel_ms_sum": tier_shadow["ms_sum"]}
        for tier in tiers:
            primary, bounce = kres[tier][key]
            times = {**shared(tier, key if tier == "flat" else f"{key}_{tier}", primary, bounce),
                     "ms": primary["queue"]["ms"], "bounce_ms": bounce["queue"]["ms"],
                     "ms_stack128": primary["queue"]["ms_stack128"],
                     "bounce_ms_stack128": bounce["queue"]["ms_stack128"],
                     f"{tier}_kernel_ms": primary["ms"], f"{tier}_kernel_bounce_ms": bounce["ms"]}
            for k in ("launches", "launches_per_frame", "main_path_stack_launches"):
                del times[k]  # the tier kernel's, not this one's
            if tier in SAME_RAYS:
                other = SAME_RAYS[tier]
                times[f"{other}_kernel_ms"] = primary[f"{other}_ms"]
                times[f"{other}_kernel_bounce_ms"] = bounce[f"{other}_ms"]
            if tier == tiers[0]:
                entry.update(times)
            else:
                entry[f"{tier}_wavefronts"] = times
        kernels.append(entry)
    # the grid-packet kernels: binary rows only; B1 on the same rays on the
    # binary and on the BVH4 table beside them
    for name, key, replaces in (
        ("B7a flat closest hit, grid packet", "closest", f"{packet}:627 (_closest_call)"),
        ("B7b flat any hit, grid packet", "any", f"{packet}:660 (_any_call)"),
    ):
        primary, bounce = pres[key]
        checked = (primary, bounce) if key == "closest" else pres["any_all"]
        err = max(r.get("max_dt_common", r.get("max_abs_err")) for r in checked)
        if key == "any":
            err = max(err, float(pres["shadow"]["occ_mismatch"] > 0))
        count = f"{key}_packet"
        entry = {
            "name": name, "route": "cuda", "source": "chameleonrt_tpu_torch/csrc/traverse_packet.cu",
            "replaces": replaces, "max_abs_err": err, **shared("grid_packet", count, primary, bounce),
            "stack_capacities": list(STACK_CAPACITIES),
            "flat_binary_kernel_ms": primary["flat_binary_ms"],
            "flat_binary_kernel_bounce_ms": bounce["flat_binary_ms"],
            "flat_kernel_ms": primary["flat_ms"], "flat_kernel_bounce_ms": bounce["flat_ms"],
            "mismatch": [r.get("prim_mismatch", r.get("occ_mismatch")) for r in checked],
        }
        # binary rows: its instantiations at arity 2
        entry.update({f"stack{cap}": ptxas[count, 2, cap] for cap in STACK_CAPACITIES})
        if key == "closest":
            for kind in ("kernel_only_hits", "tied_t_mismatch", "kernel_nearer", "plain_nearer"):
                entry[kind] = [r[kind] for r in checked]
            entry["main_path_frame"] = frame(pres["frame"])
        else:
            entry["shadow"] = shadow(pres["shadow"])
        kernels.append(entry)
    kernels.append({
        "name": "S1 shading of a bounce's live lanes", "route": "cuda",
        "source": "chameleonrt_tpu_torch/csrc/shade.cu",
        "replaces": "none (the JAX package leaves _shade_bounce to XLA's fusion)",
        "launches": {path: counts["shade_bounce"][0] for path, counts in launches.items()},
        "launches_per_frame": {path: counts["shade_bounce"][1]
                               for path, counts in launches.items()},
        **{k: v for k, v in sres.items() if k.startswith("bounce")},
        "ptxas": ptxas["shade_bounce", None, None], "library_ms": None,
    })
    kernels.append({
        "name": "R1-R3 the re-sort's bounds, int32 key and gather around torch.sort",
        "route": "cuda", "source": "chameleonrt_tpu_torch/csrc/sort.cu",
        "replaces": "none (the JAX package's re-sort is jnp.argsort and seven gathers)",
        "launches": {path: counts["sort"][0] for path, counts in launches.items()},
        "launches_per_frame": {path: counts["sort"][1] for path, counts in launches.items()},
        **{k: v for k, v in rres.items() if k.startswith("bounce")},
        "ptxas": {name: ptxas[f"sort_{name}", None, None] for name in ("bounds", "key", "gather")},
    })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(build {build_s:.1f} s)")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
