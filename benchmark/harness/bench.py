"""One run of one cell: make the inputs from the seed, set up the program,
measure a window of frames (or, traced, a bounded number of profiled
frames), read the image back, free the program, and hold what it produced
against the plain reference.

The program is driven through its public entry, as ChameleonRT's
-benchmark-frames protocol does: get_backend("cuda"), initialize(W, H),
set_scene(load_scene(path)), one warm-up render with camera_changed=True,
then render(camera_changed=False, readback_framebuffer=False) frame after
frame. A frame's render ends when its device work has (it waits for the
frame's ray count), so a frame's host time is its whole time.
"""

from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

from benchmark.harness import check, spec, trace
from benchmark.harness.roofline import DEFAULT_CARD

FORBIDDEN = ("jax", "jaxlib", "flax", "chameleonrt_tpu")


def log(*args):
    print("[bench]", *args, file=sys.stderr, flush=True)


def camera_for(config: dict, seed: int):
    """The configuration's camera, it and its look-at point shifted in x and
    y by as much as `shift` each, drawn from the seed. Returns (position,
    center, up, fov_y) as float32 arrays and a float."""
    cam = config["camera"]
    shift = np.zeros(3)
    shift[:2] = np.random.default_rng([1, seed]).uniform(-cam["shift"], cam["shift"], 2)
    return ((np.asarray(cam["position"], np.float64) + shift).astype(np.float32),
            (np.asarray(cam["center"], np.float64) + shift).astype(np.float32),
            np.asarray(cam["up"], np.float32), float(cam["fov_y"]))


def view_of(camera):
    """(pos, dir, up, fov_y), the arguments of render()."""
    pos, center, up, fov = camera
    d = (center - pos).astype(np.float32)
    return pos, d / np.linalg.norm(d), up, fov


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p90(times):
    """The 90th percentile by nearest rank."""
    xs = sorted(times)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def window_values(times, rays: int, wall: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: frame_ms, the window's wall time
    over the frames completed in it; frame_ms_p90, the 90th percentile of
    the frames' own times; mrays_per_s, all rays traced in the window over
    all of its time; setup_s."""
    return {"frame_ms": wall / max(len(times), 1) * 1e3,
            "frame_ms_p90": p90(times) * 1e3 if times else float("nan"),
            "mrays_per_s": rays / wall / 1e6, "setup_s": setup_s}


def sample_pixels(seed: int, width: int, height: int, frames: int, spp: int, lanes: int,
                  min_pixels: int, max_pixels: int):
    """A regular grid of pixels at an offset drawn from the seed: about as
    many as `lanes` (pixel, frame, sample) lanes allow, within [min_pixels,
    max_pixels]. A grid estimates the frame's ray count with far less
    spread than random pixels do, since the rays a pixel traces vary
    smoothly across the image."""
    import torch

    k = min(max(lanes // max(frames * spp, 1), min_pixels), max_pixels, width * height)
    step = max(1, int(math.ceil(math.sqrt(width * height / k))))
    ox, oy = np.random.default_rng([2, seed]).integers(0, step, 2)
    xs = torch.arange(int(ox), width, step)
    ys = torch.arange(int(oy), height, step)
    return xs.repeat(ys.shape[0]), ys.repeat_interleave(xs.shape[0])


def run_cell(cell, seed: int, seconds: float, traced: bool, t_start: float, device: str = "cuda",
             chrome_trace: str = ""):
    """Returns (result dict, check rows [[name, value, limit]])."""
    import torch

    from chameleonrt_tpu_torch.core.registry import get_backend
    from chameleonrt_tpu_torch.scene.loader import load_scene

    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    W, H, spp = cell.traffic["width"], cell.traffic["height"], cell.traffic["spp"]
    if cell.traffic["camera"] != "static":
        raise SystemExit(f"traffic camera {cell.traffic['camera']!r}: only a still camera is driven")
    camera = camera_for(cell.config, seed)
    view = view_of(camera)

    # set-up: the inputs, the scene as users load it, the tables, a warm-up frame
    tmp = tempfile.mkdtemp(prefix="bench_scene_")
    try:
        path, make_ref = cell.generator().generate(tmp, seed, cell.config, camera)
        backend = get_backend("cuda", device=device)
        backend.initialize(W, H)
        t0 = time.perf_counter()
        scene = load_scene(path)
        scene_load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    scene.samples_per_pixel = spp
    sync()
    t0 = time.perf_counter()
    backend.set_scene(scene)
    sync()
    set_scene_s = time.perf_counter() - t0
    del scene

    def frame(readback=False, changed=False):
        return backend.render(*view, camera_changed=changed, readback_framebuffer=readback)

    t0 = time.perf_counter()
    frame(changed=True)
    sync()
    warmup_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s: scene load {scene_load_s:.3f} s, set_scene {set_scene_s:.3f} s, "
        f"warm-up frame {warmup_s:.3f} s")

    attempted = failed = 0
    metrics, device_info, breakdown, record, extra = {}, {}, None, {}, {}
    finite = []
    if not traced:
        times, rays = [], 0
        t_w0 = t_b = time.perf_counter()
        while True:
            attempted += 1
            t_a = time.perf_counter()
            try:
                stats = frame()
            except Exception:  # a frame that raises is a failed frame, and ends the window
                traceback.print_exc()
                failed += 1
                t_b = time.perf_counter()
                break
            t_b = time.perf_counter()
            times.append(t_b - t_a)
            rays += stats.rays_traced
            finite.append(torch.isfinite(backend.framebuffer()).all())
            if t_b - t_w0 >= seconds:
                break
        wall = t_b - t_w0
        log(f"window {wall:.3f} s: {len(times)} frames, {rays} rays; first frames "
            f"{[round(t * 1e3, 1) for t in times[:3]]} ms, median {sorted(times)[len(times) // 2] * 1e3:.1f} ms"
            if times else f"window {wall:.3f} s: no frame")
        values = window_values(times, rays, wall, setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[spec.base_name(m["name"])], "unit": m["unit"]}
    else:
        from chameleonrt_tpu_torch.ops import traverse_cuda

        frames = int(cell.cell["profile_frames"])
        launches = sum(traverse_cuda.LAUNCHES.values())
        events, wall, rays = trace.profile_frames(torch, frame, frames, chrome_trace)
        launches = sum(traverse_cuda.LAUNCHES.values()) - launches
        seen = sum(1 for name, _, _ in events if trace.TRAVERSAL_KERNEL.search(name))
        log(f"the profiler saw {seen} of the {launches} traversal kernels the program launched "
            f"in the profiled frames")
        extra["traversal_kernels_seen_launched"] = [seen, launches]
        gaps, _ = trace.idle_gaps_by_host_op(torch, frame)
        attempted = frames + 1
        finite.append(torch.isfinite(backend.framebuffer()).all())
        busy_us = trace.union_us([(s, e) for _, s, e in events])
        device_info = {"busy_s": busy_us * 1e-6, "window_s": wall}
        breakdown = {"device_ops": trace.top_device_ops(events), "idle_gaps": gaps}
        record = {"scene_load_s": scene_load_s, "set_scene_s": set_scene_s, "frames": frames,
                  "wall_s": wall, "device_events": events, "rays": rays}
        log(f"traced {frames} frames in {wall:.3f} s, {len(events)} device events, busy "
            f"{busy_us * 1e-6:.3f} s")

    # the image, read back once after the window: one more frame's readback
    try:
        stats = frame(readback=True)
        last_rays = stats.rays_traced
        port_u8 = np.asarray(backend.img)[..., :3].copy()
    except Exception:
        traceback.print_exc()
        failed += 1
        port_u8 = None
    failed += sum(1 for f in finite if not bool(f))
    frames_rendered = backend.frame_id
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del backend
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the plain reference over the same pixels of every frame rendered
    from benchmark.reference import camera as ref_camera
    from benchmark.reference import path as ref_path

    t0 = time.perf_counter()
    tables = ref_path.build_tables(make_ref(), device)
    sync()
    tables_s = time.perf_counter() - t0
    px, py = sample_pixels(seed, W, H, frames_rendered, spp, int(cell.cell["reference_lanes"]),
                           int(cell.cell.get("min_pixels", 256)), int(cell.cell.get("max_pixels", 16384)))
    ref_view = ref_camera.compute_view_params(*view, W, H)
    accum, n_closest, n_any = ref_path.render_pixels(
        tables, ref_view, px.to(device), py.to(device), frames_rendered, W, H, spp)
    ref_u8 = ref_path.tonemap_u8(accum).cpu().numpy()
    sync()
    t1 = time.perf_counter()
    ref_frame_rays = ref_path.frame_rays(tables, ref_view, frames_rendered - 1, W, H, spp)
    ref_s = time.perf_counter() - t0
    log(f"reference {ref_s:.2f} s ({tables_s:.2f} s its tables, {time.perf_counter() - t1:.2f} s "
        f"the last frame's rays) over {px.shape[0]} pixels x {frames_rendered} frames x {spp} spp")
    if port_u8 is None:
        values = {n: float("inf") for n in check.NAMES}
    else:
        values = check.readings(port_u8[py.numpy(), px.numpy()], ref_u8, last_rays, ref_frame_rays)
        gap = np.abs(port_u8[py.numpy(), px.numpy()].astype(np.int64) - ref_u8).max(axis=1)
        log("largest channel gap of the sampled pixels, in levels: "
            + ", ".join(f"{lo}-{hi}: {int(((gap >= lo) & (gap <= hi)).sum())}"
                        for lo, hi in ((0, 0), (1, 1), (2, 8), (9, 255))))
    log("readings: " + ", ".join(f"{k} {v!r}" for k, v in values.items()))
    correct, rows = check.judge(values, cell.cell["limits"])
    correct = correct and failed == 0

    if traced:
        record["closest_share"] = n_closest / max(n_closest + n_any, 1)
        record["card"] = kind if on_card else DEFAULT_CARD
        for m in cell.per_layer():
            value = spec.metric_reader(m["name"], cell.bench_dir)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {', '.join(bad)}")
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(extra, frames_rendered=frames_rendered)
    result["reference_s"] = ref_s
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows
