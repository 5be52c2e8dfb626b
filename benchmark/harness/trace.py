"""The traced run's record: host spans, the device events of a bounded
number of profiled frames (torch.profiler, CUDA activity only), and one
more frame profiled with CPU activity for the idle gaps by host op. The
per-layer metrics (metrics/*.py) read this record; nothing here writes a
file unless a chrome trace is asked for."""

from __future__ import annotations

import bisect
import re
import time

# the traversal kernels' names (chip_smoke.py's _TRAVERSAL_KERNEL, copied)
TRAVERSAL_KERNEL = re.compile(
    r"(?<![a-z_])((?:closest|any)(?:_unified)?(?:_stream|_persistent|_packet)?)_kernel(?![a-z_])")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals (chip_smoke.py's
    _union_us, copied)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def is_transfer(name: str) -> bool:
    """Memcpy and memset device events, which are no kernels."""
    return name.startswith(("Memcpy", "Memset"))


def _device_events(prof):
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_frames(torch, render, frames: int, chrome_trace: str = ""):
    """Render `frames` frames under the profiler (CUDA activity). Returns
    (device events [(name, start us, end us)], host seconds of the frames,
    rays traced in them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    rays = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            rays += render().rays_traced
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if chrome_trace:
        prof.export_chrome_trace(chrome_trace)
    return _device_events(prof), wall, rays


def idle_gaps_by_host_op(torch, render, top: int = 10):
    """One frame under the profiler with CPU and CUDA activity: the device's
    idle gaps within the frame, each charged to the outermost host op
    running at its middle ("host" where none runs). Returns the top
    [name, seconds] by total gap time, and the frame's rays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rays = render().rays_traced
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((float(e.time_range.start), float(e.time_range.end))
                 for e in events if e.device_type == DeviceType.CUDA)
    host = sorted((float(e.time_range.start), float(e.time_range.end), e.name)
                  for e in events if e.device_type == DeviceType.CPU)
    # the outermost ops: those no other op encloses, disjoint and in order
    outer, reach = [], float("-inf")
    for hs, he, hn in sorted(host, key=lambda h: (h[0], -h[1])):
        if hs >= reach:
            outer.append((hs, he, hn))
            reach = he
    starts = [h[0] for h in outer]
    by_name = {}
    end = None
    for s, e in dev:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid) - 1
            name = outer[i][2] if i >= 0 and outer[i][1] >= mid else "host"
            by_name[name] = by_name.get(name, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top], rays


def top_device_ops(events, top: int = 10):
    """The device operations that took most time: [name, seconds]."""
    by_name = {}
    for name, s, e in events:
        m = TRAVERSAL_KERNEL.search(name)
        key = m.group(0) if m else name[:120]
        by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]
