"""Command line of the port: `python -m chameleonrt_tpu_torch.cli cuda <scene> [options]`.

A thin counterpart of chameleonrt_tpu/cli.py with the flags the flat path
needs. It renders N progressive frames at 1 spp from the scene's first
camera (or the default view), prints the benchmark summary the way cli.py does
(ms/frame, FPS, rays/s) and saves the final image.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.utils.image_io import write_image
from chameleonrt_tpu_torch.utils.util import pretty_print_count

USAGE = """Usage: python -m chameleonrt_tpu_torch.cli cuda <scene | proc://name> [options]
Options:
\t-img <x> <y>           Framebuffer dimensions (default 1280 720)
\t-benchmark-frames <n>  Frames to render (default 16)
\t-o <file.png>          Output image (default chameleonrt_cuda_out.png)
"""


def parse_args(argv: List[str]) -> Optional[dict]:
    opts = {"img": (1280, 720), "benchmark_frames": 16, "out": "chameleonrt_cuda_out.png"}
    pos = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a == "-img":
                opts["img"] = (int(argv[i + 1]), int(argv[i + 2]))
                i += 3
            elif a == "-benchmark-frames":
                opts["benchmark_frames"] = int(argv[i + 1])
                i += 2
            elif a == "-o":
                opts["out"] = argv[i + 1]
                i += 2
            elif a.startswith("-"):
                print(f"Unknown flag {a}", file=sys.stderr)
                return None
            else:
                pos.append(a)
                i += 1
    except (IndexError, ValueError):
        print(f"Error: bad value for {argv[i]}", file=sys.stderr)
        return None
    if len(pos) != 2 or opts["benchmark_frames"] < 1:
        return None
    opts["backend"], opts["scene"] = pos
    return opts


def main(argv: Optional[List[str]] = None) -> int:
    opts = parse_args(list(sys.argv[1:] if argv is None else argv))
    if opts is None:
        print(USAGE)
        return 1
    try:
        return _run(opts)
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _run(opts: dict) -> int:
    w, h = opts["img"]
    print(f"Loading scene: {opts['scene']}")
    scene = load_scene(opts["scene"])
    print(f"# Total Triangles: {pretty_print_count(scene.total_tris())}\n"
          f"# Materials: {len(scene.materials)}\n# Textures: {len(scene.textures)}")
    if scene.cameras:
        cam = scene.cameras[0]
        eye, center, up, fov = cam.position, cam.center, cam.up, cam.fov_y
    else:
        eye, center = np.array([0.0, 0.0, 5.0], np.float32), np.zeros(3, np.float32)
        up, fov = np.array([0.0, 1.0, 0.0], np.float32), 65.0

    backend = get_backend(opts["backend"])
    backend.initialize(w, h)
    print(f"Backend: {backend.name}\nDevice: {torch.cuda.get_device_name(backend.device)}")
    t0 = time.perf_counter()
    backend.set_scene(scene)
    print(f"Scene upload + build took {time.perf_counter() - t0:.2f}s")
    d = center - eye
    d = d / np.linalg.norm(d)

    n_frames = opts["benchmark_frames"]
    times, rates = [], []
    app_t0 = time.perf_counter()
    for frame in range(n_frames):
        stats = backend.render(eye, d, up, fov, camera_changed=(frame == 0),
                               readback_framebuffer=frame == n_frames - 1)
        times.append(stats.render_time)
        rates.append(stats.rays_per_second)
        if frame == 0:
            print(f"frame 0 (incl. warmup): {stats.render_time:.1f} ms")
    total = time.perf_counter() - app_t0
    steady = times[1:] or times
    avg_ms = float(np.mean(steady))
    print(f"Rendered {n_frames} frames in {total:.2f}s\n"
          f"Avg render time: {avg_ms:.2f} ms/frame ({1000.0 / max(avg_ms, 1e-6):.1f} FPS)")
    print(f"Avg rays/sec: {pretty_print_count(float(np.mean(rates[1:] or rates)))}")
    write_image(opts["out"], backend.img)
    print(f"Saved {opts['out']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
