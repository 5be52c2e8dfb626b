"""Command line of the port: `python -m chameleonrt_tpu_torch.cli <backend> <scene> [options]`.

The flag-for-flag counterpart of chameleonrt_tpu/cli.py (itself a port of
the reference CLI, main.cpp:19-36 USAGE, main.cpp:131-168 parsing):
-eye/-center/-up/-fov/-spp/-camera/-img/-mat-mode/-validation/
-benchmark-frames/-frames, checkpoint and resume, a torch.profiler trace of
the render loop, the ANSI and browser viewers and the stdin arcball
session. Default 1280x720 framebuffer, default camera eye=(0,0,5)
center=origin up=+y fov=65. It renders N progressive frames, saves PNG
frames on demand and prints the benchmark summary the reference prints at
exit (main.cpp:334-345). The scene path may be proc://<name> for the
built-in procedural scenes. Backends render on the card; -devices splits
the frame's rows over several cards and -rebalance moves rays between
them (parallel/sharded.py).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from chameleonrt_tpu_torch.core import tracing
from chameleonrt_tpu_torch.core.registry import get_backend, list_backends
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.scene.types import MaterialMode
from chameleonrt_tpu_torch.utils.image_io import write_image
from chameleonrt_tpu_torch.utils.util import get_device_brand, pretty_print_count

USAGE = """Usage: python -m chameleonrt_tpu_torch.cli <backend> <scene.obj/gltf/glb/crts/pbrt | proc://name> [options]
Backends: {backends}
Options:
\t-eye <x> <y> <z>       Set the camera position
\t-center <x> <y> <z>    Set the camera focus point
\t-up <x> <y> <z>        Set the camera up vector
\t-fov <fovy>            Specify the camera field of view (in degrees)
\t-spp <n>               Number of samples per pixel per frame (default 1)
\t-camera <n>            Use the n'th camera from the scene (default 0)
\t-img <x> <y>           Framebuffer dimensions (default 1280 720)
\t-mat-mode <MODE>       Material mode: default | white_diffuse
\t-validation <prefix>   Save every frame as <prefix><backend>-f<N>.png
\t-benchmark-frames <n>  Render n frames, print stats, save final image, exit
\t-frames <n>            Number of progressive frames to render (default 16)
\t-o <file.png>          Output image path (default chameleonrt_cuda_out.png)
\t-interactive           Read viewer commands from stdin (rotate/pan/zoom/
\t                       frame/show/save/p/q) with an arcball camera and an
\t                       ANSI terminal preview
\t-resume <state.npz>    Resume progressive accumulation from a checkpoint
\t-checkpoint <state.npz> Save accumulation state after the last frame
\t-profile <dir>         Write a torch.profiler trace of the render loop
\t                       (CPU and CUDA activity) as <dir>/render_loop.pt.trace.json,
\t                       the frame's spans (crt.*) in it, and print each span's
\t                       host ms and each counter, of the set-up and a frame
\t-display auto|ansi|none|http[:port]
\t                       Live progressive preview: ANSI in-terminal (auto:
\t                       on when stdout is a terminal and not benchmarking)
\t                       or a browser viewer at http://host:port/ (MJPEG
\t                       stream + mouse arcball; default port 8000)
\t-devices <n|all>       Shard the framebuffer rows over n devices (or all
\t                       available) with summed ray stats
\t-rebalance             With -devices: mid-path active-ray
\t                       redistribution between devices (divergent scenes)
"""

# the Chrome trace that -profile writes into its directory
PROFILE_TRACE = "render_loop.pt.trace.json"


def parse_args(argv: List[str]):
    try:
        return _parse_args(argv)
    except IndexError:
        print("Error: flag is missing its argument(s)", file=sys.stderr)
        return None
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return None


def _parse_args(argv: List[str]):
    opts = {
        "backend": None,
        "scene": None,
        "eye": np.array([0.0, 0.0, 5.0], np.float32),
        "center": np.zeros(3, np.float32),
        "up": np.array([0.0, 1.0, 0.0], np.float32),
        "fov": 65.0,
        "spp": 1,
        "camera": 0,
        "img": (1280, 720),
        "mat_mode": MaterialMode.DEFAULT,
        "validation": None,
        "benchmark_frames": 0,
        "frames": 16,
        "out": "chameleonrt_cuda_out.png",
        "got_camera_args": False,
        "interactive": False,
        "resume": None,
        "checkpoint": None,
        "profile": None,
        "display": "auto",
        "devices": 0,
        "rebalance": False,
    }
    pos: List[str] = []

    def vec3(i, flag):
        """Arity-checked 3-vector flag value (clean CLI errors are a
        claimed feature; the reference crashes on `-eye 1 2`)."""
        vals = argv[i + 1 : i + 4]
        if len(vals) < 3:
            raise ValueError(f"{flag} expects 3 values, got {len(vals)}")
        return np.array(vals, np.float32)

    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            return None
        if a == "-eye":
            opts["eye"] = vec3(i, a)
            opts["got_camera_args"] = True
            i += 4
        elif a == "-center":
            opts["center"] = vec3(i, a)
            opts["got_camera_args"] = True
            i += 4
        elif a == "-up":
            opts["up"] = vec3(i, a)
            opts["got_camera_args"] = True
            i += 4
        elif a == "-fov":
            opts["fov"] = float(argv[i + 1])
            opts["got_camera_args"] = True
            i += 2
        elif a == "-spp":
            opts["spp"] = int(argv[i + 1])
            i += 2
        elif a == "-camera":
            opts["camera"] = int(argv[i + 1])
            i += 2
        elif a == "-img":
            opts["img"] = (int(argv[i + 1]), int(argv[i + 2]))
            i += 3
        elif a == "-mat-mode":
            # unknown modes are an error, like the reference (main.cpp:158-161)
            if argv[i + 1] == "white_diffuse":
                opts["mat_mode"] = MaterialMode.WHITE_DIFFUSE
            elif argv[i + 1] != "default":
                raise ValueError(
                    f"unknown material mode '{argv[i + 1]}' "
                    "(expected default|white_diffuse)"
                )
            i += 2
        elif a == "-validation":
            opts["validation"] = argv[i + 1]
            i += 2
        elif a == "-benchmark-frames":
            opts["benchmark_frames"] = int(argv[i + 1])
            i += 2
        elif a == "-frames":
            opts["frames"] = int(argv[i + 1])
            i += 2
        elif a == "-o":
            opts["out"] = argv[i + 1]
            i += 2
        elif a == "-interactive":
            opts["interactive"] = True
            i += 1
        elif a == "-resume":
            opts["resume"] = argv[i + 1]
            i += 2
        elif a == "-checkpoint":
            opts["checkpoint"] = argv[i + 1]
            i += 2
        elif a == "-profile":
            opts["profile"] = argv[i + 1]
            i += 2
        elif a == "-display":
            v = argv[i + 1]
            if v not in ("auto", "ansi", "none") and not (
                v == "http" or v.startswith("http:")
            ):
                raise ValueError(
                    "-display expects auto|ansi|none|http[:[host:]port]"
                )
            if v.startswith("http:"):
                try:
                    int(v.rsplit(":", 1)[1])
                except ValueError:
                    raise ValueError(
                        "-display http[:[host:]port] needs an integer port"
                    )
            opts["display"] = v
            i += 2
        elif a == "-devices":
            v = argv[i + 1]
            opts["devices"] = -1 if v == "all" else int(v)
            if opts["devices"] == 0 or opts["devices"] < -1:
                raise ValueError("-devices expects a positive count or 'all'")
            i += 2
        elif a == "-rebalance":
            opts["rebalance"] = True
            i += 1
        elif not a.startswith("-"):
            pos.append(a)
            i += 1
        else:
            print(f"Unknown flag {a}")
            return None
    if len(pos) < 2:
        return None
    opts["backend"] = pos[0]
    opts["scene"] = pos[1]
    return opts


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        tracing.enable(False)


def _main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_args(argv)
    if opts is None:
        print(USAGE.format(backends=", ".join(list_backends())))
        return 1

    w, h = opts["img"]
    if opts["profile"]:
        tracing.enable(True)  # the set-up's spans too: scene.load, scene.set, native.load
    print(f"Loading scene: {opts['scene']}")
    scene = load_scene(opts["scene"], opts["mat_mode"])
    scene.samples_per_pixel = opts["spp"]

    # Scene statistics block (reference main.cpp:189-204)
    print(
        "Scene '{}':\n# Unique Triangles: {}\n# Total Triangles: {}\n"
        "# Geometries: {}\n# Meshes: {}\n# Parameterized Meshes: {}\n"
        "# Instances: {}\n# Materials: {}\n# Textures: {}\n# Lights: {}\n# Cameras: {}".format(
            opts["scene"],
            pretty_print_count(scene.unique_tris()),
            pretty_print_count(scene.total_tris()),
            scene.num_geometries(),
            len(scene.meshes),
            len(scene.parameterized_meshes),
            len(scene.instances),
            len(scene.materials),
            len(scene.textures),
            len(scene.lights),
            len(scene.cameras),
        )
    )

    # Camera selection (reference main.cpp:175-186)
    eye, center, up, fov = opts["eye"], opts["center"], opts["up"], opts["fov"]
    if not opts["got_camera_args"] and scene.cameras:
        cam = scene.cameras[min(opts["camera"], len(scene.cameras) - 1)]
        eye, center, up, fov = cam.position, cam.center, cam.up, cam.fov_y

    backend = get_backend(
        opts["backend"], devices=opts["devices"], rebalance=opts["rebalance"]
    )
    print(f"Backend: {backend.name}\nDevice: {get_device_brand()}")
    backend.initialize(w, h)
    t0 = time.perf_counter()
    backend.set_scene(scene)
    print(f"Scene upload + build took {time.perf_counter() - t0:.2f}s")

    dir = center - eye
    dir = dir / np.linalg.norm(dir)

    if opts["display"] == "http" or opts["display"].startswith("http:"):
        return run_http_viewer(backend, eye, center, up, fov, opts)

    if opts["interactive"]:
        return run_interactive(backend, eye, center, up, fov, opts)

    if opts["resume"]:
        backend.load_state(opts["resume"])
        print(f"Resumed from {opts['resume']} at frame {backend.frame_id}")

    profiler_cm = None
    if opts["profile"]:
        profiler_cm = _profiler()
        profiler_cm.__enter__()

    # Live progressive preview (the reference presents every frame to its
    # window, main.cpp:379): ANSI in-place refresh when on a terminal.
    # Benchmarks leave it off unless explicitly requested (-display ansi).
    live = None
    if opts["display"] == "ansi" or (
        opts["display"] == "auto"
        and sys.stdout.isatty()
        and not opts["benchmark_frames"]
    ):
        from chameleonrt_tpu_torch.display import AnsiDisplay

        live = AnsiDisplay(live=True)

    n_frames = opts["benchmark_frames"] or opts["frames"]
    render_times = []
    rays_per_sec = []
    app_t0 = time.perf_counter()
    for frame in range(n_frames):
        stats = backend.render(
            eye, dir, up, fov,
            camera_changed=(frame == 0 and not opts["resume"]),
            readback_framebuffer=opts["validation"] is not None
            or live is not None
            or frame == n_frames - 1,
        )
        render_times.append(stats.render_time)
        if stats.rays_per_second > 0:
            rays_per_sec.append(stats.rays_per_second)
        if opts["validation"]:
            name = f"{opts['validation']}{opts['backend']}-f{frame}.png"
            write_image(name, backend.img)
        if live is not None:
            live.display(
                backend,
                status=(
                    f"frame {frame + 1}/{n_frames}  "
                    f"{stats.render_time:.1f} ms/frame  "
                    f"{pretty_print_count(stats.rays_per_second)}ray/s"
                ),
            )
        if frame == 0 and live is None:
            print(f"frame 0 (incl. warmup): {stats.render_time:.1f} ms")
    total = time.perf_counter() - app_t0
    if profiler_cm is not None:
        profiler_cm.__exit__(None, None, None)
        os.makedirs(opts["profile"], exist_ok=True)
        trace = os.path.join(opts["profile"], PROFILE_TRACE)
        profiler_cm.export_chrome_trace(trace)
        print(f"Profiler trace written to {trace}")
        print(tracing.format_summary(tracing.frame_summary()))
    if opts["checkpoint"]:
        backend.save_state(opts["checkpoint"])
        print(f"Checkpoint saved to {opts['checkpoint']}")

    # Benchmark summary (reference main.cpp:334-345)
    steady = render_times[1:] or render_times
    avg_ms = float(np.mean(steady))
    print(
        f"Rendered {n_frames} frames in {total:.2f}s\n"
        f"Avg render time: {avg_ms:.2f} ms/frame ({1000.0 / max(avg_ms, 1e-6):.1f} FPS)"
    )
    if rays_per_sec:
        steady_rays = rays_per_sec[1:] or rays_per_sec
        print(f"Avg rays/sec: {pretty_print_count(float(np.mean(steady_rays)))}")
    write_image(opts["out"], backend.img)
    print(f"Saved {opts['out']}")
    return 0


def _profiler():
    """torch.profiler over the render loop: host activity, and the card's
    where there is one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def run_http_viewer(backend, eye, center, up, fov, opts) -> int:
    """Browser viewer loop (`-display http[:port]`): the interactive-window
    role of the reference (SDL loop + arcball + ImGui overlay,
    main.cpp:231-380) for headless GPU hosts. Serves the progressive
    framebuffer as an MJPEG stream and applies mouse arcball events between
    frames; accumulation restarts on camera motion exactly like the
    reference (camera_changed -> frame_id = 0, main.cpp:289-291).

    Runs until Ctrl-C or a {type: "quit"} input event; saves -o on exit.
    """
    from chameleonrt_tpu_torch.display.http_display import HttpDisplay
    from chameleonrt_tpu_torch.utils.arcball import ArcballCamera

    # http | http:<port> | http:<host>:<port> — loopback-only unless a
    # host is named (the viewer's /input endpoint is unauthenticated)
    host, port = "127.0.0.1", 8000
    if ":" in opts["display"]:
        rest = opts["display"].split(":", 1)[1]
        if ":" in rest:
            host, p = rest.rsplit(":", 1)
            port = int(p)
        else:
            port = int(rest)
    display = HttpDisplay(port=port, host=host)
    print(f"Viewer: http://{host}:{display.port}/  (Ctrl-C to quit)")

    camera = ArcballCamera(eye, center, up)
    camera_changed = True
    # only pay readback+encode while someone is watching or motion is fresh
    frames = 0
    try:
        while not display.closed:
            for ev in display.poll_events():
                t = ev.get("type")
                if t == "rotate":
                    camera.rotate(
                        (float(ev["x0"]), float(ev["y0"])),
                        (float(ev["x1"]), float(ev["y1"])),
                    )
                elif t == "pan":
                    camera.pan((float(ev["dx"]), float(ev["dy"])))
                elif t == "zoom":
                    camera.zoom(float(ev["amount"]))
                else:
                    continue
                camera_changed = True
            stats = backend.render(
                camera.eye,
                camera.dir,
                camera.up,
                fov,
                camera_changed,
                readback_framebuffer=True,
            )
            camera_changed = False
            display.set_stats(
                stats.render_time, stats.rays_per_second, backend.frame_id
            )
            display.display(backend)
            frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        display.close()
    if backend.frame_id > 0:
        write_image(opts["out"], backend.img)
        print(f"\nSaved {opts['out']} after {frames} frames")
    return 0


def run_interactive(backend, eye, center, up, fov, opts) -> int:
    """Stdin-driven viewer loop: the headless counterpart of the reference's
    SDL event loop + arcball (main.cpp:231-380, util/arcball_camera.h).

    Commands:
      rotate x0 y0 x1 y1   arcball rotate (normalized-device coords)
      pan dx dy            pan the center of interest
      zoom amount          dolly toward/away from the center
      frame [n]            render n progressive frames (default 1)
      show                 ANSI terminal preview of the framebuffer
      save <path.png>      write the framebuffer (reference 's' key)
      p                    print camera eye/center/up (reference 'p' key)
      stats                print last RenderStats
      q                    quit (saves -o image first)
    """
    from chameleonrt_tpu_torch.display import AnsiDisplay
    from chameleonrt_tpu_torch.utils.arcball import ArcballCamera

    camera = ArcballCamera(eye, center, up)
    # on a real terminal, refresh the preview live after every command that
    # renders (the reference redraws its window each loop, main.cpp:379)
    auto_show = opts.get("display") == "ansi" or (
        opts.get("display") == "auto" and sys.stdout.isatty()
    )
    ansi = AnsiDisplay(live=auto_show)
    camera_changed = True
    last_stats = None

    def render_frames(n):
        nonlocal camera_changed, last_stats
        e = camera.eye
        d = camera.dir
        u = camera.up
        for k in range(n):
            last_stats = backend.render(
                e, d, u, fov, camera_changed and k == 0,
                readback_framebuffer=(k == n - 1),
            )
            if camera_changed and k == 0:
                camera_changed = False
        if auto_show:
            ansi.display(backend)

    print("interactive mode; type 'help' for commands", flush=True)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, args = parts[0], parts[1:]
        try:
            if cmd == "q":
                break
            elif cmd == "help":
                print(run_interactive.__doc__)
            elif cmd == "rotate":
                x0, y0, x1, y1 = map(float, args)
                camera.rotate((x0, y0), (x1, y1))
                camera_changed = True
                if auto_show:
                    render_frames(1)
            elif cmd == "pan":
                camera.pan(tuple(map(float, args)))
                camera_changed = True
                if auto_show:
                    render_frames(1)
            elif cmd == "zoom":
                camera.zoom(float(args[0]))
                camera_changed = True
                if auto_show:
                    render_frames(1)
            elif cmd == "frame":
                render_frames(int(args[0]) if args else 1)
            elif cmd == "show":
                if backend.frame_id == 0:
                    render_frames(1)
                ansi.display(backend)
            elif cmd == "save":
                write_image(args[0], backend.img)
                print(f"saved {args[0]}")
            elif cmd == "p":
                e, c, u = camera.eye, camera.center, camera.up
                print(
                    f"-eye {e[0]:g} {e[1]:g} {e[2]:g} "
                    f"-center {c[0]:g} {c[1]:g} {c[2]:g} "
                    f"-up {u[0]:g} {u[1]:g} {u[2]:g} -fov {fov:g}"
                )
            elif cmd == "stats":
                if last_stats:
                    print(
                        f"{last_stats.render_time:.2f} ms/frame, "
                        f"{pretty_print_count(last_stats.rays_per_second)}ray/s, "
                        f"frame_id={backend.frame_id}"
                    )
                else:
                    print("no frame rendered yet")
            else:
                print(f"unknown command '{cmd}' (try 'help')")
        except Exception as e:  # noqa: BLE001
            print(f"error: {e}")
        print("> ", end="", flush=True)
    if backend.frame_id > 0:
        write_image(opts["out"], backend.img)
        print(f"Saved {opts['out']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
