#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
CUDA card, nvcc, g++ and the repository's sources, and imports neither JAX
nor the JAX package (it asserts so at its end). Phases:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch, CUDA and nvcc versions;
2. build: the traversal kernels (csrc/*.cu, one nvcc each, in parallel);
3. kernels against their plain torch versions on the card, each with
   kernel and plain times on a sorted primary wavefront and a
   diffuse-bounce wavefront from its hit points:
   - B1/B2 (flat) on proc://hall?subdiv=2 at 320x180 and on the textured
     hall at 1280x720, and B2 on the 10 masked shadow-ray wavefronts of
     one 1280x720 hall frame;
   - B3/B4 (two-level) on proc://instances?nx=4&ny=4&subdiv=2 at 320x180
     and on the San Miguel proxy at 1280x720, and B4 on the 10 masked
     shadow-ray wavefronts of one 1-spp San Miguel frame at 1280x720;
   - B5a/B5b (the streamed tier, whose plain versions are B1/B2's) on
     proc://city?n=60 at 320x180, forced, and on the 6.7M-triangle
     proc://city?n=610 at 640x360, which the gate must route to them, any
     hit at both t_max factors on both wavefronts, with B1/B2 timed on the
     same rays; and B5b on the 10 masked shadow-ray wavefronts of one
     640x360 city frame;
   - B5c/B5d (the two-level streamed tier, whose plain versions are
     B3/B4's) on proc://instances?nx=4&ny=4&subdiv=2 at 320x180, forced,
     and on the large San Miguel proxy (gen://san_miguel?leaf_tris=700000
     &canopy_instances=10: 95 instances, 9.67M instanced triangles, a
     two-level table about three times the L2) at 1280x720, which the gate
     must route to them, any hit at both t_max factors on both wavefronts,
     with B3/B4 timed on the same rays; and B5d on the 10 masked shadow-ray
     wavefronts of one 1-spp 1280x720 frame of it;
   each kernel's least time on its main-path primary wavefront (bound_ms)
   comes from the distinct rows and the operations that wavefront's rays
   need, counted by the plain walk (ops/traverse.py WalkCount);
4. images through the kernels against images through the plain traversal
   (textured hall, proc://instances?nx=6&ny=6&subdiv=3 and, with
   stream=True, proc://city?n=60 and proc://instances?nx=6&ny=6&subdiv=3;
   128x72, 2 frames each): 8-bit mean abs difference < 1;
5. the main paths, each with the kernels' launch counts set to 0 just
   before it and read just after: get_backend("cuda") rendering
   proc://hall?subdiv=4&textured=1 at 1280x720, 1 spp (B1/B2), the San
   Miguel proxy (gen://san_miguel: 155 instances, 9.67M instanced
   triangles, generated as bench.py does) at 1280x720, 4 spp (B3/B4), the
   city proc://city?n=610 at 640x360, 1 spp (B5a/B5b), and the large San
   Miguel proxy at 1280x720, 4 spp (B5c/B5d); each path's last frame runs
   under torch.profiler, which gives where its time goes: device busy
   time, the idle share of the frame, and the device time of the traversal
   kernels and of the largest other rows.

A gen://san_miguel URI is this script's own: _load generates the scene
with the port's scene/pbrt_gen.py (its query string gives the generator's
arguments) into the build directory and loads it through the port's PBRT
loader. Scenes are loaded once per URI.

Every phase raises on failure and the script then exits nonzero. The line
before the last is a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
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
PROFILE_FRAMES = 1
# traversal gates (the JAX bench's parity gates): prim (and instance) /
# occlusion mismatches <= max(2, R / 50000), |dt| and |du|, |dv| over
# common hits <= 1e-5
DT_TOL = 1e-5
UV_TOL = 1e-5
# timings: median of this many CUDA-event timed calls after one warmup (for
# the plain version, the parity call just before is the warmup); the plain
# walks over the San Miguel proxies and the city take ~1 s a call, so they
# get fewer
KERNEL_REPS = 5
PLAIN_REPS = 5
PLAIN_REPS_SAN_MIGUEL = 3
PLAIN_REPS_CITY = 3
PLAIN_REPS_LARGE = 1
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


def phase_build():
    from chameleonrt_tpu_torch import _build

    t0 = time.perf_counter()
    _build.kernels()
    secs = time.perf_counter() - t0
    log(f"[build] traversal kernels built and loaded in {secs:.2f} s")
    with open(_build.kernel_library_path()[: -len(".so")] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] ptxas: {line.strip()}")
    return secs


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


def _scene_tables(torch, uri):
    """(scene, FlatScene with its tables on the card, SceneMeta), built once
    per URI."""
    from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
    from chameleonrt_tpu_torch.engine.trace_bvh import build_blas_set

    if uri not in _TABLES:
        scene = _load(uri)
        flat, meta = build_device_scene(scene, torch.device("cuda"))
        _TABLES[uri] = (scene, flat._replace(blas=build_blas_set(flat, meta)), meta)
    return _TABLES[uri]


def _bound(table, count, active, out_bytes):
    """The least time of a kernel's call on the counted rays: the larger of
    the bytes it must move (each distinct node, leaf and entry row the rays
    visit read once, every lane's inputs read once, its results written
    once) over the memory rate, and its FP32 operations (the live lanes'
    reciprocals, a slab test per live child of each visited node row, a
    Moller-Trumbore per valid slot of each visited leaf row, a transform
    per instance entry) over the FP32 rate."""
    c = dict(count.totals(), rays=active.shape[0], live=int(active.sum()))
    L = table.leaf_rows.shape[1] // 10
    row_bytes = table.nodes.shape[1] * 4
    n_bytes = (c["node_rows"] * row_bytes + c["leaf_rows"] * 10 * L * 4 + c["entry_rows"] * 14 * 4
               + c["rays"] * (RAY_IN_BYTES + out_bytes))
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
}
SAME_RAYS = {"stream": "flat", "unified_stream": "unified"}
TWO_LEVEL = ("unified", "unified_stream")


def _kernel_pair(path: str, closest: bool):
    """(label, kernel wrapper, plain version) of a path's closest- or
    any-hit kernel."""
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda

    label, kernel, plain = _PATHS[path][0 if closest else 1]
    return label, getattr(traverse_cuda, kernel), getattr(traverse, plain)


def _check_closest(torch, table, path, orig, dirs, t_min, active, label, plain_reps, bound=False):
    """Kernel against plain closest hit; returns (result, t, prim, inst)
    of the plain version (inst None in a flat scene). On a streamed path
    the unstreamed kernel is timed on the same rays too (e.g. flat_ms).
    bound: count the plain walk and give the kernel's least time."""
    from chameleonrt_tpu_torch.ops.intersect import T_MAX
    from chameleonrt_tpu_torch.ops.traverse import WalkCount

    unified = path in TWO_LEVEL
    name, kernel, plain = _kernel_pair(path, closest=True)
    R = orig.shape[0]
    t_max = torch.full((R,), T_MAX, dtype=torch.float32, device="cuda")
    k = kernel(table, orig, dirs, t_min, active, t_max)
    torch.cuda.synchronize()
    count = WalkCount(table) if bound else None
    p = plain(table, orig, dirs, t_min, active, t_max, count=count)
    tk, pk, uk, vk = k[0], k[1], k[-2], k[-1]
    tp, pp, up, vp = p[0], p[1], p[-2], p[-1]
    mism_lanes = pk != pp
    if unified:
        mism_lanes |= k[2] != p[2]
    common = (pk >= 0) & (pp >= 0)
    mism = int(mism_lanes.sum())
    dt = float((tk - tp)[common].abs().max()) if bool(common.any()) else 0.0
    duv = float(torch.maximum((uk - up).abs(), (vk - vp).abs())[common].max()) if bool(common.any()) else 0.0
    ok = mism <= max(2, R // 50000) and dt <= DT_TOL and duv <= UV_TOL
    res = {"rays": R, "active": int(active.sum()), "hits": int((pk >= 0).sum()),
           "overflows": int((pk == -2).sum()), "prim_mismatch": mism, "max_dt_common": dt,
           "max_duv_common": duv, "ok": ok}
    if unified:
        res["instances_hit"] = int(torch.unique(k[2][pk >= 0]).numel())
    if bound:
        res.update(_bound(table, count, active, 20 if unified else 16))
    res["ms"] = _median_ms(torch, lambda: kernel(table, orig, dirs, t_min, active, t_max), KERNEL_REPS)
    if path in SAME_RAYS:
        other = _kernel_pair(SAME_RAYS[path], closest=True)[1]
        res[f"{SAME_RAYS[path]}_ms"] = _median_ms(
            torch, lambda: other(table, orig, dirs, t_min, active, t_max), KERNEL_REPS)
    res["plain_ms"] = _median_ms(torch, lambda: plain(table, orig, dirs, t_min, active, t_max),
                                 plain_reps, warmup=False)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} closest {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version on {label}: {res}")
    return res, tp, pp, (p[2] if unified else None)


def _check_any(torch, table, path, orig, dirs, t_closest, active, label, factor, plain_reps,
               bound=False):
    """t_max = factor * the closest hit (100 on a miss). factor 1.001 is the
    JAX bench's gate: a hitting ray is occluded, mostly by that very
    triangle, and stops early. factor 0.999 stops just short of it, so a ray
    walks every box in front of its hit and is rarely occluded. On a
    streamed path the unstreamed kernel is timed on the same rays too.
    bound as in _check_closest."""
    from chameleonrt_tpu_torch.ops.math import EPSILON
    from chameleonrt_tpu_torch.ops.traverse import WalkCount

    name, kernel, plain = _kernel_pair(path, closest=False)
    R = orig.shape[0]
    t_max = torch.where(t_closest < 1e19, t_closest * factor, torch.full_like(t_closest, 100.0))
    t_min = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
    ok_k = kernel(table, orig, dirs, t_min, t_max, active)
    torch.cuda.synchronize()
    count = WalkCount(table) if bound else None
    ok_p = plain(table, orig, dirs, t_min, t_max, active, count=count)
    mism = int((ok_k != ok_p).sum())
    ok = mism <= max(2, R // 50000)
    res = {"rays": R, "t_max_factor": factor, "occluded": int(ok_k.sum()), "occ_mismatch": mism,
           "max_abs_err": float((ok_k.float() - ok_p.float()).abs().max()), "ok": ok}
    if bound:
        res.update(_bound(table, count, active, 1))
    res["ms"] = _median_ms(torch, lambda: kernel(table, orig, dirs, t_min, t_max, active), KERNEL_REPS)
    if path in SAME_RAYS:
        other = _kernel_pair(SAME_RAYS[path], closest=False)[1]
        res[f"{SAME_RAYS[path]}_ms"] = _median_ms(
            torch, lambda: other(table, orig, dirs, t_min, t_max, active), KERNEL_REPS)
    res["plain_ms"] = _median_ms(torch, lambda: plain(table, orig, dirs, t_min, t_max, active),
                                 plain_reps, warmup=False)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} any {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version on {label}: {res}")
    return res


# launch-count key of each path's any-hit kernel
_ANY_COUNT = {"flat": "any", "unified": "any_unified", "stream": "any_stream",
              "unified_stream": "any_unified_stream"}


def _check_any_shadow(torch, scene, tables, path, W, H, spp=1):
    """The any-hit kernel on a main path's own traffic: the 10 masked
    shadow-ray wavefronts of one W x H frame at one sample per pixel (per
    bounce, light samples and then bsdf samples toward the lights),
    captured through the backend (on the scene's tables, already built)
    and traced again by the plain version. Requires zero mismatches, some
    occluded rays, and 10 launches of the path's any-hit kernel, so on a
    streamed path the gate must have picked it."""
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.engine.trace_bvh import make_trace_fns
    from chameleonrt_tpu_torch.ops import traverse_cuda

    name = _kernel_pair(path, closest=False)[0]
    count = _ANY_COUNT[path]
    b = CudaBackend()
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
    pos, d, up, fov = _view(scene)
    before = traverse_cuda.LAUNCHES[count]
    b.render(pos, d, up, fov, True, readback_framebuffer=False)
    launched = traverse_cuda.LAUNCHES[count] - before
    _, plain_any = make_trace_fns(b.meta, use_kernels=False)
    per_call = []
    for orig, dirs, t_max, mask, occ in calls:
        occ_p = plain_any(b.flat, orig, dirs, t_max, mask)
        per_call.append((int(mask.sum()), int(occ.sum()), int((occ != occ_p).sum())))
    res = {"rays": W * H, "spp": spp, "calls": len(calls), "launches": launched,
           "masked_in": [c[0] for c in per_call], "occluded": [c[1] for c in per_call],
           "occ_mismatch": sum(c[2] for c in per_call)}
    res["ok"] = (len(calls) == 10 and launched == 10 and res["occ_mismatch"] == 0
                 and sum(res["occluded"]) > 0 and all(0 < c[0] < W * H for c in per_call[:2]))
    log(f"[kernels] {name} any main-path shadow rays, one {W}x{H} frame: {json.dumps(res)}")
    if not res["ok"]:
        raise AssertionError(f"{name} disagrees with its plain version on the main path's shadow rays: {res}")
    return res


def phase_kernels(torch, path: str):
    """The closest- and any-hit kernels of one path against their plain
    versions on two scenes, with kernel and plain times and, on the main
    path's primary wavefront, the kernels' least times; then the any-hit
    kernel on one main-path frame's shadow rays. Returns {"closest":
    (primary, bounce), "any": (primary, bounce), "any_all": [...],
    "shadow": ...} at the main path's shape. A streamed path checks any hit
    at both t_max factors on both wavefronts, times the unstreamed kernels
    beside its own, and asserts that the gate routes its main-path scene to
    the streamed tier; the unified path asserts that it does not."""
    from chameleonrt_tpu_torch.engine.trace_bvh import streamed_tier, table_bytes
    from chameleonrt_tpu_torch.ops.math import EPSILON

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
                f"streamed tier by the gate {tier}")
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
        r3, bt, _, _ = _check_closest(torch, table, path, bo, bd, eps, bact, f"{label} bounce", reps)
        a2 = [_check_any(torch, table, path, bo, bd, bt, bact, f"{label} bounce", f, reps)
              for f in factors[1]]
        out = {"closest": (r1, r3), "any": (a1[0], a2[-1]), "any_all": a1 + a2}
    # the last case is the main path's scene: its tables serve the shadow check
    W, H = (CITY_W, CITY_H) if path == "stream" else (MAIN_W, MAIN_H)
    out["shadow"] = _check_any_shadow(torch, scene, (flat, meta), path, W, H)
    return out


def phase_image(torch, uri, stream=None, expect=None):
    """Two 128x72 frames through the kernels against two through the plain
    traversal. stream=True forces the streamed tier; expect, if given, is
    the set of launch counts that must have moved (and no other)."""
    import numpy as np

    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    scene = _load(uri)
    pos, d, up, fov = _view(scene)
    imgs = {}
    before = dict(traverse_cuda.LAUNCHES)
    for use_kernels in (True, False):
        b = CudaBackend(use_kernels=use_kernels, stream=stream)
        b.initialize(128, 72)
        b.set_scene(scene)
        for i in range(2):
            b.render(pos, d, up, fov, i == 0, readback_framebuffer=(i == 1))
        imgs[use_kernels] = b.img[..., :3].astype(np.float32)
    diff = np.abs(imgs[True] - imgs[False])
    mad = float(diff.mean())
    launched = {k: n - before[k] for k, n in traverse_cuda.LAUNCHES.items() if n != before[k]}
    log(f"[image] {uri} 128x72 x2 frames{', stream=True' if stream else ''}, kernels vs plain "
        f"traversal: 8-bit mean abs diff {mad:.6f} (gate < 1.0), max {float(diff.max())}, "
        f"image mean {float(imgs[True].mean()):.3f}, launches {launched}")
    if not mad < 1.0 or not imgs[True].max() > 0:
        raise AssertionError(f"kernel image of {uri} differs from the plain image or is black: MAD {mad}")
    if expect is not None and set(launched) != set(expect):
        raise AssertionError(f"{uri}{' with stream=True' if stream else ''} launched {launched}, "
                             f"expected {sorted(expect)} only")


# a traversal kernel's name, mangled (...29closest_unified_stream_kernelE...)
# or not ((anonymous namespace)::closest_unified_stream_kernel(float const*,
# ...); the group is its launch-count key
_TRAVERSAL_KERNEL = re.compile(r"(?<![a-z_])((?:closest|any)(?:_unified)?(?:_stream)?)_kernel(?![a-z_])")


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


def phase_main(torch, uri, W, H, spp, timed_frames, expect):
    """get_backend("cuda") on uri at W x H and spp samples per pixel
    (set after set_scene, as bench.py does): one warmup, timed_frames
    frames timed on the host clock and PROFILE_FRAMES profiled frames
    (_profile_frames), with every launch count set to 0 just before and
    read just after. expect maps each count to its launches per frame.
    Returns {count: (launches in the run, launches per frame)} of the
    kernels that ran."""
    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    scene = _load(uri)
    pos, d, up, fov = _view(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    for k in traverse_cuda.LAUNCHES:
        traverse_cuda.LAUNCHES[k] = 0
    backend = get_backend("cuda")
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
    res = {
        "scene": uri, "width": W, "height": H, "spp": spp,
        "unique_tris": backend.meta.num_tris, "instances": backend.meta.num_instances,
        "instanced_tris": scene.total_tris(),
        "set_scene_s": set_scene_s, "warmup_ms": stats[0][0] * 1e3,
        "ms_per_frame": ms, "min_ms": min(ms), "median_ms": statistics.median(ms),
        "rays_per_frame": rays, "mray_s_median": statistics.median(mray_s),
        "peak_mem_bytes": peak, "allocated_before_bytes": allocated_before,
        "launches": launches, "frames": n_frames,
    }
    log(f"[main] {json.dumps(res)}")
    log(f"[profile] {uri}: {json.dumps(profiled)}")
    want = {k: expect.get(k, 0) * n_frames for k in launches}
    if launches != want:
        raise AssertionError(f"expected {want} launches over {n_frames} frames, got {launches}")
    accum = backend._accum
    if tuple(accum.shape) != (H, W, 3) or not bool(torch.isfinite(accum).all()):
        raise AssertionError("accumulated image is not a finite (H, W, 3) buffer")
    if not float(accum.max()) > 0.0 or int(backend.img[..., :3].max()) == 0:
        raise AssertionError("accumulated image is all black")
    log(f"[main] {uri}: image mean {float(accum.mean()):.5f}, max {float(accum.max()):.5f}; "
        f"8-bit image mean {float(backend.img[..., :3].mean()):.3f}")
    return {k: (n, n // n_frames) for k, n in launches.items() if n}


def _main_paths():
    """Each main path: (scene, width, height, spp, timed frames, launches
    per frame by launch-count key)."""
    return {
        "flat": (HALL_SCENE, MAIN_W, MAIN_H, 1, HALL_TIMED_FRAMES, {"closest": 5, "any": 10}),
        "unified": (SAN_MIGUEL, MAIN_W, MAIN_H, SM_SPP, SM_TIMED_FRAMES,
                    {"closest_unified": 5 * SM_SPP, "any_unified": 10 * SM_SPP}),
        "stream": (CITY_SCENE, CITY_W, CITY_H, 1, CITY_TIMED_FRAMES,
                   {"closest_stream": 5, "any_stream": 10}),
        "unified_stream": (SAN_MIGUEL_LARGE, MAIN_W, MAIN_H, SM_SPP, LARGE_TIMED_FRAMES,
                           {"closest_unified_stream": 5 * SM_SPP,
                            "any_unified_stream": 10 * SM_SPP}),
    }


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

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_toolchain(torch)
    phase_build()
    kres = {path: phase_kernels(torch, path) for path in _PATHS}
    phase_image(torch, HALL_IMAGE)
    phase_image(torch, INST_IMAGE)
    phase_image(torch, CITY_PARITY, stream=True, expect={"closest_stream", "any_stream"})
    phase_image(torch, INST_IMAGE, stream=True,
                expect={"closest_unified_stream", "any_unified_stream"})
    _TABLES.clear()  # the main paths build their own tables; peak memory is theirs
    gc.collect()
    torch.cuda.empty_cache()
    launches = {path: phase_main(torch, *args) for path, args in _main_paths().items()}
    foreign = _foreign_modules()
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign}")

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
         "traverse_stream.cu", f"{slotlane}:1025 (_closest_unified_call_slotlane, stream=True)"),
        ("B5d two-level any hit, streamed tier", "unified_stream", "any",
         "traverse_stream.cu", f"{slotlane}:1085 (_any_unified_call_slotlane, stream=True)"),
    ):
        primary, bounce = kres[path][key]
        checked = (primary, bounce) if key == "closest" else kres[path]["any_all"]
        err = max(r.get("max_dt_common", r.get("max_abs_err")) for r in checked)
        if key == "any":
            err = max(err, float(kres[path]["shadow"]["occ_mismatch"] > 0))
        count = key if path == "flat" else f"{key}_{path}"
        entry = {
            "name": name, "route": "cuda", "source": f"chameleonrt_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[path][count][0],
            "launches_per_frame": launches[path][count][1], "max_abs_err": err,
            "ms": primary["ms"], "plain_ms": primary["plain_ms"],
            "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"], "library_ms": None,
            "bounce_ms": bounce["ms"], "bounce_plain_ms": bounce["plain_ms"],
        }
        if path in SAME_RAYS:  # the unstreamed kernels on the same wavefronts
            other = SAME_RAYS[path]
            entry[f"{other}_kernel_ms"] = primary[f"{other}_ms"]
            entry[f"{other}_kernel_bounce_ms"] = bounce[f"{other}_ms"]
        kernels.append(entry)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
