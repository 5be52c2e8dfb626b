"""The program's own spans and counters in a traced run
(chameleonrt_tpu_torch/core/tracing.py), for the span metrics
(metrics/sort_device_ms.py, compact_device_ms.py, shade_device_ms.py,
sync_idle_ms.py, host_syncs_per_frame.py, shade_host_ms.py).

The traced run's own passes (harness/bench.py) run with the program's spans
off, so that their kernels and busy time hold no user annotation. The
first span metric read in a run (span_record) then makes a span run: the
same cell and seed once more through bench.run_cell, untraced, with the
spans on, so its set-up, warm-up frame, window, readback and the
reference's check of every frame it rendered are the harness's own. Of its
window, the first profile_frames frames give each span's host self time
and the counters a frame, with no profiler; the next frame, the span
frame, runs under the profiler (CPU and CUDA activity; tracing.enable's
profile_frame): its kernels are charged to the innermost span that held
their launch, matched through the profiler's correlation ids, and its
idle gaps to the innermost span open on the host when each gap opened
(span_charges). The window is as long as the harness's profiled frames
took, and half a frame more, so that it ends after the span frame. It
logs the span run's result, the set-up's spans, every span's device ms,
kernels, idle ms and host ms a frame, the counters, and the program's
closest-hit share of its rays. The result is kept in record["spans"] for
the other span metrics; where the span run is not correct, there is none.

A program without spans (an older checkout) gives None, as does a read
outside a bench.run_cell call.
"""

from __future__ import annotations

import bisect
import sys
import time
import traceback

from benchmark.harness import bench
from benchmark.harness.trace import TRAVERSAL_KERNEL, is_transfer

# the program's spans enter torch.profiler.record_function under this prefix
SPAN_PREFIX = "crt."
NO_SPAN = "(no span)"


def log(*args):
    print("[bench spans]", *args, file=sys.stderr, flush=True)


def program_tracing():
    """The program's tracing module, or None where the program has none."""
    try:
        from chameleonrt_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def spans_and_launches(events):
    """The program's spans in profiler events, as the host ran them [(name,
    start us, end us)], and every device event [(name, start us, end us,
    host us of its launch or None, whether it is a user annotation)]. A
    device event's launch is the runtime call that carries its correlation
    id, or else the host op (or span) its launch is linked to."""
    from torch.autograd import DeviceType

    spans, runtime, ops, device = [], {}, {}, []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            annotation = bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(SPAN_PREFIX)
            device.append((e.name, s, t, e.id, getattr(e, "linked_correlation_id", 0), annotation))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(SPAN_PREFIX):
                spans.append((e.name[len(SPAN_PREFIX):], s, t))
            # runtime and driver calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
            # carry the device event's own correlation id, host ops the one it is linked to
            (runtime if e.name.startswith("cu") else ops)[e.id] = s
    launched = []
    for name, s, t, cid, linked, annotation in device:
        launch = runtime.get(cid) if cid and cid in runtime else ops.get(linked) if linked else None
        launched.append((name, s, t, launch, annotation))
    return spans, launched


def _innermost(spans):
    """innermost(t): the name of the innermost span open at host time t
    (NO_SPAN where none is, or where t is None). Spans nest, so of the
    spans that hold t the innermost is the last to start."""
    order = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    starts = [sp[1] for sp in order]

    def innermost(t):
        if t is None:
            return NO_SPAN
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if order[i][2] >= t:
                return order[i][0]
            i -= 1
        return NO_SPAN

    return innermost


def span_charges(spans: dict) -> dict:
    """The span frame's device work by span, a frame: {"device_ms": kernel
    ms charged to the innermost span that held the kernel's launch,
    "kernels": the kernels so charged, "idle_ms": device idle charged to
    the innermost span open on the host when the gap opened}. User
    annotations (the spans' own device ranges) are no device work; memcpy
    and memset are busy time but no kernels."""
    innermost = _innermost(spans["span_host"])
    frames = spans["span_frames"]
    device_ms, kernels, idle_ms, busy = {}, {}, {}, []
    for name, s, e, launch, annotation in spans["span_device"]:
        if annotation:
            continue
        busy.append((s, e))
        if is_transfer(name):
            continue
        where = innermost(launch)
        device_ms[where] = device_ms.get(where, 0.0) + (e - s) / 1e3 / frames
        kernels[where] = kernels.get(where, 0.0) + 1.0 / frames
    end = None
    for s, e in sorted(busy):
        if end is not None and s > end:
            where = innermost(end)
            idle_ms[where] = idle_ms.get(where, 0.0) + (s - end) / 1e3 / frames
        end = e if end is None else max(end, e)
    return {"device_ms": device_ms, "kernels": kernels, "idle_ms": idle_ms}


def _running_cell():
    """(cell, seed, device): the arguments of the bench.run_cell call that
    reads the metric, or None where none is running."""
    frame = sys._getframe()
    while frame is not None:
        if frame.f_code is bench.run_cell.__code__:
            return frame.f_locals["cell"], frame.f_locals["seed"], frame.f_locals["device"]
        frame = frame.f_back
    return None


def span_record(record: dict):
    """record["spans"]: the span run's record with its span_charges, made
    once a run (module docstring), or None where it cannot be made. Never
    raises."""
    if "spans" not in record:
        try:
            record["spans"] = _span_run(record)
        except Exception:  # a span metric that cannot be read is missing, and the run goes on
            traceback.print_exc()
            record["spans"] = None
    spans = record["spans"]
    if spans is not None and "device_ms" not in spans:
        spans.update(span_charges(spans))
    return spans


def _span_run(record: dict):
    tracing = program_tracing()
    running = _running_cell()
    if tracing is None or running is None or not record.get("frames"):
        return None
    cell, seed, device = running
    frames = int(record["frames"])
    span_frame = frames + 2  # frame 1 is the warm-up
    seconds = (frames + 0.5) * record["wall_s"] / frames
    log(f"the span run: {cell.name} seed {seed} through bench.run_cell, untraced, spans on, "
        f"a window of {seconds:.3f} s: frames 2-{span_frame - 1} without a profiler, frame "
        f"{span_frame} the span frame")
    tracing.enable(True, profile_frame=span_frame)
    try:
        result, rows = bench.run_cell(cell, seed, seconds, False, time.perf_counter(), device)
    finally:
        tracing.enable(False)
    summary = tracing.frame_summary(range(2, span_frame))
    profile = tracing.PROFILE[0] if tracing.PROFILE else None
    log(f"the span run: correct {result['correct']}, attempted {result['attempted']}, failed "
        f"{result['failed']}, frames rendered {result['frames_rendered']}; "
        + ", ".join(f"{name} {value!r} limit {limit!r}" for name, value, limit in rows))
    log("set-up, host ms (self): " + ", ".join(f"{k} {v:.2f}" for k, v in summary["setup_ms"].items())
        + "; " + ", ".join(f"{k} {v}" for k, v in summary["setup_counts"].items()))
    if not result["correct"]:
        log("the span run is not correct: no span metric")
        return None
    if profile is None:
        log(f"the window ended before frame {span_frame}: no span frame")
        host, device_events = [], []
    else:
        host, device_events = spans_and_launches(profile.events())
        tracing.PROFILE.clear()
    spans = {"span_host_ms": summary["host_ms"], "counts": summary["counts"], "span_host": host,
             "span_device": device_events, "span_frames": 1}
    spans.update(span_charges(spans))
    unlaunched = sum(1 for name, _, _, launch, annotation in device_events
                     if launch is None and not annotation and not is_transfer(name))
    log(f"the span frame: {len(host)} spans, {len(device_events)} device events, {unlaunched} kernels "
        f"with no launch found; {summary['frames']} frames without a profiler")
    for key in ("device_ms", "kernels", "idle_ms", "span_host_ms"):
        log(f"{key} a frame by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(spans[key].items(), key=lambda kv: -kv[1])))
    kernel_ms = sum(spans["device_ms"].values())
    below = kernel_ms - spans["device_ms"].get("frame", 0.0) - spans["device_ms"].get(NO_SPAN, 0.0)
    traversal = {}
    innermost = _innermost(host)
    for name, _, _, launch, annotation in device_events:
        if not annotation and TRAVERSAL_KERNEL.search(name):
            where = innermost(launch)
            traversal[where] = traversal.get(where, 0) + 1
    log(f"kernel ms a frame {kernel_ms:.3f}, {100 * below / max(kernel_ms, 1e-9):.3f}% of it charged to "
        f"spans below frame; traversal kernels by span: {traversal}")
    counts = spans["counts"]
    rays = counts.get("rays.closest", 0) + counts.get("rays.any", 0)
    log("counters a frame: " + ", ".join(f"{k} {v:g}" for k, v in counts.items())
        + f"; closest-hit share of the rays: program {counts.get('rays.closest', 0) / max(rays, 1)!r}, "
        f"reference {record.get('closest_share')!r}")
    return spans
