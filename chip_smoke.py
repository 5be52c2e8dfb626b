#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
CUDA card, nvcc and the repository's sources, and imports no JAX. Phases:

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
4. images through the kernels against images through the plain traversal
   (textured hall, proc://instances?nx=6&ny=6&subdiv=3 and, with
   stream=True, proc://city?n=60; 128x72, 2 frames each): 8-bit mean abs
   difference < 1;
5. the main paths, each with the kernels' launch counts set to 0 just
   before it and read just after: get_backend("cuda") rendering
   proc://hall?subdiv=4&textured=1 at 1280x720, 1 spp (B1/B2), the San
   Miguel proxy (gen://san_miguel: 155 instances, 9.67M instanced
   triangles, generated as bench.py does) at 1280x720, 4 spp (B3/B4), and
   the city proc://city?n=610 at 640x360, 1 spp (B5a/B5b).

Every phase raises on failure and the script then exits nonzero. The line
before the last is a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
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
# traversal gates (the JAX bench's parity gates): prim (and instance) /
# occlusion mismatches <= max(2, R / 50000), |dt| and |du|, |dv| over
# common hits <= 1e-5
DT_TOL = 1e-5
UV_TOL = 1e-5
# timings: median of this many CUDA-event timed calls after one warmup;
# the plain two-level walk over the San Miguel proxy takes ~1 s a call,
# so it gets fewer
KERNEL_REPS = 5
PLAIN_REPS = 5
PLAIN_REPS_SAN_MIGUEL = 3
PLAIN_REPS_CITY = 3


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


def _load(uri):
    """The scene at uri; gen://san_miguel is generated first, as bench.py
    does, into the build directory."""
    from chameleonrt_tpu.scene.loader import load_scene

    if uri == SAN_MIGUEL:
        from chameleonrt_tpu.scene.pbrt_gen import generate_san_miguel_proxy
        from chameleonrt_tpu_torch import _build

        uri = generate_san_miguel_proxy(os.path.join(_build.BUILD_DIR, "san_miguel"))
    return load_scene(uri)


def _scene_tables(torch, uri):
    from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
    from chameleonrt_tpu_torch.engine.trace_bvh import build_blas_set

    scene = _load(uri)
    flat, meta = build_device_scene(scene, torch.device("cuda"))
    return scene, flat._replace(blas=build_blas_set(flat, meta)), meta


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


def _median_ms(torch, fn, reps):
    fn()  # warmup
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


def _kernel_pair(path: str, closest: bool):
    """(label, kernel wrapper, plain version) of a path: "flat" (B1/B2),
    "unified" (B3/B4) or "stream" (B5a/B5b, whose plain versions are
    B1/B2's)."""
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda

    return {
        ("flat", True): ("B1", traverse_cuda.traverse_closest, traverse.traverse_closest),
        ("flat", False): ("B2", traverse_cuda.traverse_any, traverse.traverse_any),
        ("unified", True): ("B3", traverse_cuda.traverse_closest_unified,
                            traverse.traverse_closest_unified),
        ("unified", False): ("B4", traverse_cuda.traverse_any_unified,
                             traverse.traverse_any_unified),
        ("stream", True): ("B5a", traverse_cuda.traverse_closest_stream, traverse.traverse_closest),
        ("stream", False): ("B5b", traverse_cuda.traverse_any_stream, traverse.traverse_any),
    }[(path, closest)]


def _check_closest(torch, table, path, orig, dirs, t_min, active, label, plain_reps):
    """Kernel against plain closest hit; returns (result, t, prim, inst)
    of the plain version (inst None in a flat scene). On the stream path
    B1 is timed on the same rays too (flat_ms)."""
    from chameleonrt_tpu_torch.ops.intersect import T_MAX

    unified = path == "unified"
    name, kernel, plain = _kernel_pair(path, closest=True)
    R = orig.shape[0]
    t_max = torch.full((R,), T_MAX, dtype=torch.float32, device="cuda")
    k = kernel(table, orig, dirs, t_min, active, t_max)
    torch.cuda.synchronize()
    p = plain(table, orig, dirs, t_min, active, t_max)
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
           "prim_mismatch": mism, "max_dt_common": dt, "max_duv_common": duv, "ok": ok}
    if unified:
        res["instances_hit"] = int(torch.unique(k[2][pk >= 0]).numel())
    res["ms"] = _median_ms(torch, lambda: kernel(table, orig, dirs, t_min, active, t_max), KERNEL_REPS)
    if path == "stream":
        flat_kernel = _kernel_pair("flat", closest=True)[1]
        res["flat_ms"] = _median_ms(torch, lambda: flat_kernel(table, orig, dirs, t_min, active, t_max),
                                    KERNEL_REPS)
    res["plain_ms"] = _median_ms(torch, lambda: plain(table, orig, dirs, t_min, active, t_max), plain_reps)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} closest {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version on {label}: {res}")
    return res, tp, pp, (p[2] if unified else None)


def _check_any(torch, table, path, orig, dirs, t_closest, active, label, factor, plain_reps):
    """t_max = factor * the closest hit (100 on a miss). factor 1.001 is the
    JAX bench's gate: a hitting ray is occluded, mostly by that very
    triangle, and stops early. factor 0.999 stops just short of it, so a ray
    walks every box in front of its hit and is rarely occluded. On the
    stream path B2 is timed on the same rays too (flat_ms)."""
    from chameleonrt_tpu_torch.ops.math import EPSILON

    name, kernel, plain = _kernel_pair(path, closest=False)
    R = orig.shape[0]
    t_max = torch.where(t_closest < 1e19, t_closest * factor, torch.full_like(t_closest, 100.0))
    t_min = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
    ok_k = kernel(table, orig, dirs, t_min, t_max, active)
    torch.cuda.synchronize()
    ok_p = plain(table, orig, dirs, t_min, t_max, active)
    mism = int((ok_k != ok_p).sum())
    ok = mism <= max(2, R // 50000)
    res = {"rays": R, "t_max_factor": factor, "occluded": int(ok_k.sum()), "occ_mismatch": mism,
           "max_abs_err": float((ok_k.float() - ok_p.float()).abs().max()), "ok": ok}
    res["ms"] = _median_ms(torch, lambda: kernel(table, orig, dirs, t_min, t_max, active), KERNEL_REPS)
    if path == "stream":
        flat_kernel = _kernel_pair("flat", closest=False)[1]
        res["flat_ms"] = _median_ms(torch, lambda: flat_kernel(table, orig, dirs, t_min, t_max, active),
                                    KERNEL_REPS)
    res["plain_ms"] = _median_ms(torch, lambda: plain(table, orig, dirs, t_min, t_max, active), plain_reps)
    res["plain_reps"] = plain_reps
    log(f"[kernels] {name} any {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version on {label}: {res}")
    return res


def _check_any_shadow(torch, scene, tables, path, W, H, spp=1):
    """The any-hit kernel on a main path's own traffic: the 10 masked
    shadow-ray wavefronts of one W x H frame at one sample per pixel (per
    bounce, light samples and then bsdf samples toward the lights),
    captured through the backend (on the scene's tables, already built)
    and traced again by the plain version. Requires zero mismatches, some
    occluded rays, and 10 launches of the path's any-hit kernel, so on the
    stream path the gate must have picked B5b."""
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.engine.trace_bvh import make_trace_fns
    from chameleonrt_tpu_torch.ops import traverse_cuda

    name = _kernel_pair(path, closest=False)[0]
    count = {"flat": "any", "unified": "any_unified", "stream": "any_stream"}[path]
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
    versions on two scenes, with kernel and plain times, and the any-hit
    kernel on one main-path frame's shadow rays. Returns {"closest":
    (primary, bounce), "any": (primary, bounce), "any_all": [...],
    "shadow": ...} at the main path's shape. The stream path checks any hit
    at both t_max factors on both wavefronts, times B1/B2 beside B5a/B5b,
    and asserts that the gate routes the full city to the streamed tier."""
    from chameleonrt_tpu_torch.engine.trace_bvh import streamed_tier, table_bytes
    from chameleonrt_tpu_torch.ops.math import EPSILON

    if path == "unified":
        cases = (("parity instances nx=4 ny=4 320x180", INST_PARITY, 320, 180, PLAIN_REPS),
                 ("main-path San Miguel proxy 1280x720", SAN_MIGUEL, MAIN_W, MAIN_H,
                  PLAIN_REPS_SAN_MIGUEL))
    elif path == "flat":
        cases = (("parity hall subdiv=2 320x180", HALL_PARITY, 320, 180, PLAIN_REPS),
                 ("main-path hall 1280x720", HALL_SCENE, MAIN_W, MAIN_H, PLAIN_REPS))
    else:
        cases = (("parity city n=60 320x180", CITY_PARITY, 320, 180, PLAIN_REPS),
                 ("main-path city n=610 640x360", CITY_SCENE, CITY_W, CITY_H, PLAIN_REPS_CITY))
    stream = path == "stream"
    factors = ((1.001, 0.999), (1.001, 0.999)) if stream else ((1.001,), (0.999,))
    out = {}
    for label, uri, W, H, reps in cases:
        scene, flat, meta = _scene_tables(torch, uri)
        table = flat.blas[0].any
        if path == "unified":
            log(f"[kernels] {label}: two-level BVH4 table {tuple(table.nodes.shape)} nodes, "
                f"{tuple(table.leaf_rows.shape)} leaf rows, n_tri_leaves {table.n_tri_leaves}, "
                f"tlas_lo {table.tlas_lo}, stack_bound {table.stack_bound}, "
                f"{meta.num_instances} instances of {len(meta.mesh_tri_ranges)} meshes")
        if stream:
            tier = streamed_tier(table)
            l2 = torch.cuda.get_device_properties(0).L2_cache_size
            log(f"[kernels] {label}: {meta.num_tris} tris, BVH4 table {tuple(table.nodes.shape)} "
                f"nodes, {tuple(table.leaf_rows.shape)} leaf rows, {table_bytes(table)} bytes "
                f"against an L2 of {l2}: streamed tier by the gate {tier}; max_depth {table.max_depth}")
            if uri == CITY_SCENE and not tier:
                raise AssertionError(f"the gate does not route {uri} to the streamed tier")
        orig, dirs, active = _primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        zeros = torch.zeros((R,), dtype=torch.float32, device="cuda")
        r1, t, prim, inst = _check_closest(torch, table, path, orig, dirs, zeros, active,
                                           f"{label} primary", reps)
        a1 = [_check_any(torch, table, path, orig, dirs, t, active, f"{label} primary", f, reps)
              for f in factors[0]]
        bo, bd, bact = _bounce_wavefront(torch, flat, orig, dirs, t, prim, inst)
        eps = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
        r3, bt, _, _ = _check_closest(torch, table, path, bo, bd, eps, bact, f"{label} bounce", reps)
        a2 = [_check_any(torch, table, path, bo, bd, bt, bact, f"{label} bounce", f, reps)
              for f in factors[1]]
        out = {"closest": (r1, r3), "any": (a1[0], a2[-1]), "any_all": a1 + a2}
        del table
    # the last case is the main path's scene: its tables serve the shadow check
    W, H = (CITY_W, CITY_H) if stream else (MAIN_W, MAIN_H)
    out["shadow"] = _check_any_shadow(torch, scene, (flat, meta), path, W, H)
    return out


def phase_image(torch, uri, stream=None):
    """Two 128x72 frames through the kernels against two through the plain
    traversal; stream=True forces the flat path onto B5a/B5b and checks
    that they ran."""
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
    if stream and set(launched) != {"closest_stream", "any_stream"}:
        raise AssertionError(f"stream=True did not trace {uri} through B5a/B5b: {launched}")


def phase_main(torch, uri, W, H, spp, timed_frames, expect):
    """get_backend("cuda") on uri at W x H and spp samples per pixel
    (set after set_scene, as bench.py does): one warmup and timed_frames
    timed frames, with every launch count set to 0 just before and read
    just after. expect maps each count to its launches per frame."""
    import numpy as np

    from chameleonrt_tpu.core import get_backend
    from chameleonrt_tpu_torch.ops import traverse_cuda

    scene = _load(uri)
    pos, d, up, fov = _view(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    launches = dict(traverse_cuda.LAUNCHES)
    timed = stats[1:]
    ms = [s * 1e3 for s, _ in timed]
    rays = [st.rays_traced for _, st in timed]
    mray_s = [r / s / 1e6 for (s, _), r in zip(timed, rays)]
    peak = torch.cuda.max_memory_allocated()
    res = {
        "scene": uri, "width": W, "height": H, "spp": spp,
        "unique_tris": backend.meta.num_tris, "instances": backend.meta.num_instances,
        "instanced_tris": scene.total_tris(),
        "set_scene_s": set_scene_s, "warmup_ms": stats[0][0] * 1e3,
        "ms_per_frame": ms, "min_ms": min(ms), "median_ms": statistics.median(ms),
        "rays_per_frame": rays, "mray_s_median": statistics.median(mray_s),
        "peak_mem_bytes": peak, "launches": launches, "frames": n_frames,
    }
    log(f"[main] {json.dumps(res)}")
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
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "chameleonrt_tpu_torch")):
        print("chip_smoke.py must run from the repository root", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chameleonrt_tpu_torch  # noqa: F401  (registers the cuda backend)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_toolchain(torch)
    phase_build()
    kres = {path: phase_kernels(torch, path) for path in ("flat", "unified", "stream")}
    phase_image(torch, HALL_IMAGE)
    phase_image(torch, INST_IMAGE)
    phase_image(torch, CITY_PARITY, stream=True)
    launches = {
        "flat": phase_main(torch, HALL_SCENE, MAIN_W, MAIN_H, 1, HALL_TIMED_FRAMES,
                           {"closest": 5, "any": 10}),
        "unified": phase_main(torch, SAN_MIGUEL, MAIN_W, MAIN_H, SM_SPP, SM_TIMED_FRAMES,
                              {"closest_unified": 5 * SM_SPP, "any_unified": 10 * SM_SPP}),
        "stream": phase_main(torch, CITY_SCENE, CITY_W, CITY_H, 1, CITY_TIMED_FRAMES,
                             {"closest_stream": 5, "any_stream": 10}),
    }
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

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
    ):
        primary, bounce = kres[path][key]
        checked = (primary, bounce) if key == "closest" else kres[path]["any_all"]
        err = max(r.get("max_dt_common", r.get("max_abs_err")) for r in checked)
        if key == "any":
            err = max(err, float(kres[path]["shadow"]["occ_mismatch"] > 0))
        count = key if path == "flat" else f"{key}_{path}"
        entry = {
            "name": name, "route": "cuda", "source": f"chameleonrt_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[path][count], "max_abs_err": err,
            "ms": primary["ms"], "plain_ms": primary["plain_ms"],
            "bounce_ms": bounce["ms"], "bounce_plain_ms": bounce["plain_ms"],
        }
        if "flat_ms" in primary:  # B1/B2 on the same wavefronts
            entry["flat_kernel_ms"] = primary["flat_ms"]
            entry["flat_kernel_bounce_ms"] = bounce["flat_ms"]
        kernels.append(entry)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
