"""The readings that a cell's correctness limits are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds <s> [--program] [--control]

--program: for each seed, one whole run of the cell in this process
(bench.run_cell: set-up, a window of --seconds, the reference), and its
numbers compared. --control: for each seed, the lower-precision control
put in the program's place: the reference with its per-lane state stored
in bfloat16 (reference/path.py, lowp=True), held against the float32
reference on the same pixels and as many frames as --frames (or a
program run's frames) by the same numbers. Prints one JSON line per seed
and kind; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(cell, seed: int, frames: int, device: str = "cuda") -> dict:
    """The control's numbers for one seed over `frames` frames."""
    import tempfile

    from benchmark.harness import bench, check
    from benchmark.reference import camera as ref_camera
    from benchmark.reference import path as ref_path

    W, H, spp = cell.traffic["width"], cell.traffic["height"], cell.traffic["spp"]
    camera = bench.camera_for(cell.config, seed)
    with tempfile.TemporaryDirectory() as tmp:
        _, make_ref = cell.generator().generate(tmp, seed, cell.config, camera)
    tables = ref_path.build_tables(make_ref(), device)
    px, py = bench.sample_pixels(seed, W, H, frames, spp, int(cell.cell["reference_lanes"]),
                                 int(cell.cell.get("min_pixels", 256)),
                                 int(cell.cell.get("max_pixels", 16384)))
    view = ref_camera.compute_view_params(*bench.view_of(camera), W, H)
    out = {}
    for lowp in (False, True):
        accum, _, _ = ref_path.render_pixels(tables, view, px.to(device), py.to(device), frames,
                                             W, H, spp, lowp=lowp)
        out[lowp] = (ref_path.tonemap_u8(accum).cpu().numpy(),
                     ref_path.frame_rays(tables, view, frames - 1, W, H, spp, lowp=lowp))
    return check.readings(out[True][0], out[False][0], out[True][1], out[False][1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--frames", type=int, default=0, help="the control's frames without --program")
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import bench, spec

    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        frames = args.frames
        if args.program:
            result, _ = bench.run_cell(cell, seed, args.seconds, False, time.perf_counter())
            frames = result["frames_rendered"]
            print(json.dumps({"kind": "program", "seed": seed, "frames": frames,
                              "correct": result["correct"], "metrics": result["metrics"],
                              "reference_s": result["reference_s"],
                              "readings": {k: v["value"] for k, v in result["checks"].items()}}),
                  flush=True)
        if args.control:
            t0 = time.perf_counter()
            values = control_readings(cell, seed, frames)
            print(json.dumps({"kind": "control", "seed": seed, "frames": frames,
                              "seconds": time.perf_counter() - t0, "readings": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
