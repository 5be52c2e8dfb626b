#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
CUDA card, nvcc and the repository's sources, and imports no JAX. Phases:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch, CUDA and nvcc versions;
2. build: the traversal kernels (csrc/traverse_flat.cu) with nvcc;
3. kernels against their plain torch versions on the card, at the parity
   shape (proc://hall?subdiv=2 at 320x180) and at the main path's shape
   (the textured hall at 1280x720): a sorted primary wavefront and a
   diffuse-bounce wavefront from its hit points, with kernel and plain
   times; and B2 on the 10 masked shadow-ray wavefronts of one main-path
   frame;
4. an image through the kernels against one through the plain traversal
   (textured hall, 128x72, 2 frames): 8-bit mean abs difference < 1;
5. the main path: get_backend("cuda") rendering
   proc://hall?subdiv=4&textured=1 at 1280x720, 1 spp, with the kernels'
   launch counts read around it.

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
MAIN_SCENE = "proc://hall?subdiv=4&textured=1"
PARITY_SCENE = "proc://hall?subdiv=2"
IMAGE_SCENE = "proc://hall?subdiv=1&textured=1&columns=4"
MAIN_W, MAIN_H = 1280, 720
TIMED_FRAMES = 4
# traversal gates (the JAX bench's parity gates): prim / occlusion
# mismatches <= max(2, R / 50000), |dt| and |du|, |dv| over common hits <= 1e-5
DT_TOL = 1e-5
UV_TOL = 1e-5


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


def _scene_tables(torch, uri):
    from chameleonrt_tpu.scene.loader import load_scene
    from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
    from chameleonrt_tpu_torch.engine.trace_bvh import build_blas_set

    scene = load_scene(uri)
    flat, meta = build_device_scene(scene, torch.device("cuda"))
    return scene, flat._replace(blas=build_blas_set(flat, meta)), meta


def _primary_wavefront(torch, scene, W, H):
    """Sorted primary rays, as the JAX bench's _parity_wavefront builds them."""
    import numpy as np

    from chameleonrt_tpu_torch.ops import camera, rng
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

    cam = scene.cameras[0]
    d = cam.center - cam.position
    d = d / np.linalg.norm(d)
    view = camera.compute_view_params(cam.position, d, cam.up, cam.fov_y, W, H)
    ys, xs = torch.meshgrid(
        torch.arange(H, device="cuda"), torch.arange(W, device="cuda"), indexing="ij"
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    state = rng.get_rng(px + py * W, 1)
    _, orig, dirs = camera.generate_primary_rays(view, px, py, float(W), float(H), state)
    active = torch.ones(orig.shape[0], dtype=torch.bool, device="cuda")
    perm = ray_sort_perm_only(orig, dirs, active)
    return orig[perm].contiguous(), dirs[perm].contiguous(), active


def _bounce_wavefront(torch, flat, orig, dirs, t, prim):
    """Diffuse-bounce rays from the primary hit points: uniform directions
    in the hemisphere of the face normal that faces the incoming ray, from
    a seeded generator; lanes whose primary ray missed are inactive."""
    from chameleonrt_tpu_torch.ops.math import cross, dot, normalize
    from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

    hit = prim >= 0
    p = orig + torch.where(hit, t, torch.zeros_like(t))[:, None] * dirs
    srow = flat.shade_rows[prim.clamp(min=0).long()]
    n = normalize(cross(srow[:, 0:3], srow[:, 3:6]))
    n = torch.where((dot(n, dirs) > 0)[:, None], -n, n)
    g = torch.Generator(device="cuda").manual_seed(11)
    w = normalize(torch.randn(orig.shape, generator=g, device="cuda"))
    w = torch.where((dot(w, n) < 0)[:, None], -w, w)
    perm = ray_sort_perm_only(p, w, hit)
    return p[perm].contiguous(), w[perm].contiguous(), hit[perm].contiguous()


def _median_ms(torch, fn, reps=5):
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


def _check_closest(torch, pbvh, orig, dirs, t_min, active, label, timed):
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda
    from chameleonrt_tpu_torch.ops.intersect import T_MAX

    R = orig.shape[0]
    t_max = torch.full((R,), T_MAX, dtype=torch.float32, device="cuda")
    k = traverse_cuda.traverse_closest(pbvh, orig, dirs, t_min, active, t_max)
    torch.cuda.synchronize()
    p = traverse.traverse_closest(pbvh, orig, dirs, t_min, active, t_max)
    (tk, pk, uk, vk), (tp, pp, up, vp) = k, p
    common = (pk >= 0) & (pp >= 0)
    mism = int((pk != pp).sum())
    dt = float((tk - tp)[common].abs().max()) if bool(common.any()) else 0.0
    duv = float(torch.maximum((uk - up).abs(), (vk - vp).abs())[common].max()) if bool(common.any()) else 0.0
    ok = mism <= max(2, R // 50000) and dt <= DT_TOL and duv <= UV_TOL
    res = {"rays": R, "hits": int((pk >= 0).sum()), "prim_mismatch": mism,
           "max_dt_common": dt, "max_duv_common": duv, "ok": ok}
    if timed:
        res["ms"] = _median_ms(torch, lambda: traverse_cuda.traverse_closest(
            pbvh, orig, dirs, t_min, active, t_max))
        res["plain_ms"] = _median_ms(torch, lambda: traverse.traverse_closest(
            pbvh, orig, dirs, t_min, active, t_max))
    log(f"[kernels] B1 closest {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"B1 disagrees with its plain version on {label}: {res}")
    return res, tp, pp


def _check_any(torch, pbvh, orig, dirs, t_closest, active, label, timed, factor):
    """t_max = factor * the closest hit (100 on a miss). factor 1.001 is the
    JAX bench's gate: a hitting ray is occluded, mostly by that very
    triangle, and stops early. factor 0.999 stops just short of it, so a ray
    walks every box in front of its hit and is rarely occluded."""
    from chameleonrt_tpu_torch.ops import traverse, traverse_cuda
    from chameleonrt_tpu_torch.ops.math import EPSILON

    R = orig.shape[0]
    t_max = torch.where(t_closest < 1e19, t_closest * factor, torch.full_like(t_closest, 100.0))
    t_min = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
    ok_k = traverse_cuda.traverse_any(pbvh, orig, dirs, t_min, t_max, active)
    torch.cuda.synchronize()
    ok_p = traverse.traverse_any(pbvh, orig, dirs, t_min, t_max, active)
    mism = int((ok_k != ok_p).sum())
    ok = mism <= max(2, R // 50000)
    res = {"rays": R, "occluded": int(ok_k.sum()), "occ_mismatch": mism,
           "max_abs_err": float((ok_k.float() - ok_p.float()).abs().max()), "ok": ok}
    if timed:
        res["ms"] = _median_ms(torch, lambda: traverse_cuda.traverse_any(
            pbvh, orig, dirs, t_min, t_max, active))
        res["plain_ms"] = _median_ms(torch, lambda: traverse.traverse_any(
            pbvh, orig, dirs, t_min, t_max, active))
    log(f"[kernels] B2 any {label}: {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"B2 disagrees with its plain version on {label}: {res}")
    return res


def _check_any_shadow(torch, scene):
    """B2 on the main path's own traffic: the 10 masked shadow-ray
    wavefronts of one 1280x720 frame (per bounce, light samples and then
    bsdf samples toward the lights), captured through the backend and
    traced again by the plain version. Requires zero mismatches and some
    occluded rays."""
    import numpy as np

    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
    from chameleonrt_tpu_torch.engine.trace_bvh import make_trace_fns

    b = CudaBackend()
    b.initialize(MAIN_W, MAIN_H)
    b.set_scene(scene)
    trace_closest, trace_any = b._trace
    calls = []

    def capture(flat, orig, dir, t_max, mask):
        occ = trace_any(flat, orig, dir, t_max, mask)
        calls.append((orig.clone(), dir.clone(), t_max.clone(), mask.clone(), occ.clone()))
        return occ

    b._trace = (trace_closest, capture)
    cam = scene.cameras[0]
    d = cam.center - cam.position
    b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True, readback_framebuffer=False)
    _, plain_any = make_trace_fns(b.meta, use_kernels=False)
    per_call = []
    for orig, dirs, t_max, mask, occ in calls:
        occ_p = plain_any(b.flat, orig, dirs, t_max, mask)
        per_call.append((int(mask.sum()), int(occ.sum()), int((occ != occ_p).sum())))
    res = {"rays": MAIN_W * MAIN_H, "calls": len(calls),
           "masked_in": [c[0] for c in per_call], "occluded": [c[1] for c in per_call],
           "occ_mismatch": sum(c[2] for c in per_call)}
    res["ok"] = (len(calls) == 10 and res["occ_mismatch"] == 0 and sum(res["occluded"]) > 0
                 and all(0 < c[0] < MAIN_W * MAIN_H for c in per_call[:2]))
    log(f"[kernels] B2 any main-path shadow rays, one frame: {json.dumps(res)}")
    if not res["ok"]:
        raise AssertionError(f"B2 disagrees with its plain version on the main path's shadow rays: {res}")
    return res


def phase_kernels(torch):
    """B1 and B2 against their plain versions on two scenes, with kernel
    and plain times, and B2 on one main-path frame's shadow rays. Returns
    {kernel: (primary, bounce) results at the main path's shape}."""
    from chameleonrt_tpu_torch.ops.math import EPSILON

    out = {}
    for label, uri, W, H, timed in (
        ("parity hall subdiv=2 320x180", PARITY_SCENE, 320, 180, True),
        ("main-path hall 1280x720", MAIN_SCENE, MAIN_W, MAIN_H, True),
    ):
        scene, flat, meta = _scene_tables(torch, uri)
        pbvh = flat.blas[0].any
        orig, dirs, active = _primary_wavefront(torch, scene, W, H)
        R = orig.shape[0]
        zeros = torch.zeros((R,), dtype=torch.float32, device="cuda")
        r1, t, prim = _check_closest(torch, pbvh, orig, dirs, zeros, active, f"{label} primary", timed)
        r2 = _check_any(torch, pbvh, orig, dirs, t, active, f"{label} primary", timed, 1.001)
        bo, bd, bact = _bounce_wavefront(torch, flat, orig, dirs, t, prim)
        eps = torch.full((R,), EPSILON, dtype=torch.float32, device="cuda")
        r3, bt, _ = _check_closest(torch, pbvh, bo, bd, eps, bact, f"{label} bounce", timed)
        r4 = _check_any(torch, pbvh, bo, bd, bt, bact, f"{label} bounce", timed, 0.999)
        out = {"closest": (r1, r3), "any": (r2, r4)}
        del flat
    out["shadow"] = _check_any_shadow(torch, scene)
    return out


def phase_image(torch):
    import numpy as np

    from chameleonrt_tpu.scene.loader import load_scene
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend

    scene = load_scene(IMAGE_SCENE)
    cam = scene.cameras[0]
    d = cam.center - cam.position
    d = d / np.linalg.norm(d)
    imgs = {}
    for use_kernels in (True, False):
        b = CudaBackend(use_kernels=use_kernels)
        b.initialize(128, 72)
        b.set_scene(scene)
        for i in range(2):
            b.render(cam.position, d, cam.up, cam.fov_y, i == 0, readback_framebuffer=(i == 1))
        imgs[use_kernels] = b.img[..., :3].astype(np.float32)
    mad = float(np.abs(imgs[True] - imgs[False]).mean())
    log(f"[image] {IMAGE_SCENE} 128x72 x2 frames, kernels vs plain traversal: "
        f"8-bit mean abs diff {mad:.6f} (gate < 1.0), max {float(np.abs(imgs[True] - imgs[False]).max())}")
    if not mad < 1.0:
        raise AssertionError(f"kernel image differs from the plain image: MAD {mad}")


def phase_main(torch):
    import numpy as np

    from chameleonrt_tpu.core import get_backend
    from chameleonrt_tpu.scene.loader import load_scene
    from chameleonrt_tpu_torch.ops import traverse_cuda

    scene = load_scene(MAIN_SCENE)
    cam = scene.cameras[0]
    d = cam.center - cam.position
    d = d / np.linalg.norm(d)
    torch.cuda.reset_peak_memory_stats()
    for k in traverse_cuda.LAUNCHES:
        traverse_cuda.LAUNCHES[k] = 0
    backend = get_backend("cuda")
    backend.initialize(MAIN_W, MAIN_H)
    t0 = time.perf_counter()
    backend.set_scene(scene)
    set_scene_s = time.perf_counter() - t0
    stats = []
    n_frames = 1 + TIMED_FRAMES
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = backend.render(cam.position, d, cam.up, cam.fov_y, i == 0,
                            readback_framebuffer=(i == n_frames - 1))
        torch.cuda.synchronize()
        stats.append((time.perf_counter() - t0, st))
    launches = dict(traverse_cuda.LAUNCHES)
    timed = stats[1:]
    ms = [s * 1e3 for s, _ in timed]
    rays = [st.rays_traced for _, st in timed]
    mray_s = [r / s / 1e6 for (s, _), r in zip(timed, rays)]
    peak = torch.cuda.max_memory_allocated()
    tris = sum(c for _, c in backend.meta.mesh_tri_ranges)
    res = {
        "scene": MAIN_SCENE, "width": MAIN_W, "height": MAIN_H, "spp": 1, "tris": tris,
        "set_scene_s": set_scene_s, "warmup_ms": stats[0][0] * 1e3,
        "ms_per_frame": ms, "min_ms": min(ms), "median_ms": statistics.median(ms),
        "rays_per_frame": rays, "mray_s_median": statistics.median(mray_s),
        "peak_mem_bytes": peak, "launches": launches, "frames": n_frames,
    }
    log(f"[main] {json.dumps(res)}")
    if launches["closest"] != 5 * n_frames or launches["any"] != 10 * n_frames:
        raise AssertionError(f"expected 5 closest and 10 any launches per frame, got {launches}")
    accum = backend._accum
    if tuple(accum.shape) != (MAIN_H, MAIN_W, 3) or not bool(torch.isfinite(accum).all()):
        raise AssertionError("accumulated image is not a finite (H, W, 3) buffer")
    if not float(accum.max()) > 0.0 or int(backend.img[..., :3].max()) == 0:
        raise AssertionError("accumulated image is all black")
    log(f"[main] image mean {float(accum.mean()):.5f}, max {float(accum.max()):.5f}; "
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_toolchain(torch)
    phase_build()
    kres = phase_kernels(torch)
    phase_image(torch)
    launches = phase_main(torch)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    src = "chameleonrt_tpu_torch/csrc/traverse_flat.cu"
    kernels = []
    for name, key, replaces in (
        ("B1 flat closest hit", "closest",
         "chameleonrt_tpu/ops/traverse_slotlane.py:771 (_closest_call_slotlane)"),
        ("B2 flat any hit", "any",
         "chameleonrt_tpu/ops/traverse_slotlane.py:835 (_any_call_slotlane)"),
    ):
        primary, bounce = kres[key]
        err = primary.get("max_dt_common", primary.get("max_abs_err"))
        err = max(err, bounce.get("max_dt_common", bounce.get("max_abs_err")))
        if key == "any":
            err = max(err, float(kres["shadow"]["occ_mismatch"] > 0))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err,
            "ms": primary["ms"], "plain_ms": primary["plain_ms"],
            "bounce_ms": bounce["ms"], "bounce_plain_ms": bounce["plain_ms"],
        })
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
