"""Spans and counters inside the port's set-up and frame.

Off by default. enable(True) turns them on; the CLI's -profile does so
for its set-up and render loop, and the benchmark's traced runs for a run
of their own. Off, span() and sync() return one shared no-op context and
call nothing in torch, and count() and count_on_device() do nothing; this
module imports torch only once tracing is on.

On, a span enters torch.profiler.record_function("crt." + name), so that a
profiler trace shows it on the clock of the device events, and keeps
[name, parent index, frame, bounce, start ns, end ns] in SPANS from
time.perf_counter_ns(), so that host time is known without a profiler.
Frames are numbered from 1 after enable(); a span outside every frame
(set-up) has frame 0. COUNTS holds host integers by (frame, counter);
DEVICE_COUNTS holds 0-dim device tensors that read_with() reads in the
frame's one ray-count read, so that counting adds no host sync.
frame_summary() sums both up, a frame and for the set-up, and clears them.
enable(True, profile_frame=n) also runs frame n under torch.profiler (CPU
activity, and CUDA activity where there is a card) and keeps the profile
in PROFILE.

Spans (each nested under the one that caused it):
    frame                 TorchRenderBackend.render, launch to the end of device work
    frame.sample          one sample's wavefront: its camera and bounce loop
    frame.camera          seeding and primary rays
    bounce.sort           the wavefront's re-sort
    bounce.exchange       the rebalance exchange between shards
    bounce.closest        the closest-hit traversal
    bounce.compact        the live lanes' nonzero, gathers and scatter-back
    bounce.shade          the shading of the live lanes (inside bounce.compact)
    bounce.any            both occlusion traversals
    bounce.combine        the rest of a bounce
    frame.accumulate      the scatter to input order and the progressive average
    frame.readback        tonemap and copy to the host
    sync.<site>           a blocking device-to-host read: compact.nonzero,
                          frame.rays, exchange.counts
    scene.load            load_scene
    scene.set             set_scene, with scene.set.tables and scene.set.trace_fns
    kernels.load          the CUDA kernels' library built or found, and loaded
                          (at the first kernel launch, so in the first frame)
    native.load           the native builder's library built or found, and loaded

Counters: host_syncs (one a sync span), rays.closest and rays.any (their
sum is RenderStats.rays_traced), lanes.shaded (lanes shaded),
lanes.shaded_kernel (of them, the lanes the shading kernel S1 shaded),
lanes.sorted_kernel (the lanes the re-sort's kernels R1-R3 sorted, every
lane of every bounce on the card), and
kernel_builds and native_builds (1 where this process ran nvcc or the
C++ compiler). Set-up counters of set_scene: tables.instances,
tables.triangles (unique, before instancing) and tables.bytes (the BVH
tables' node and leaf rows).
"""

from __future__ import annotations

import contextlib
import time

_NULL = contextlib.nullcontext()
_on = False
_profile_frame = 0  # the frame to run under torch.profiler, 0 for none
SPANS = []  # [name, parent index or -1, frame (0: set-up), bounce, start ns, end ns (0 while open)]
COUNTS = {}  # (frame, name) -> int, since the last frame_summary()
DEVICE_COUNTS = {}  # name -> [0-dim int64 tensors], until read_with() reads them
PROFILE = []  # the torch.profiler.profile of frame _profile_frame, once it has ended
_open = []  # indices into SPANS of the spans open now, outermost first
_frames = 0  # `frame` spans opened since enable(True)


def enable(on: bool = True, profile_frame: int = 0) -> None:
    """Turn tracing on (clearing what was recorded) or off (keeping it for
    frame_summary). profile_frame: the number of a frame (from 1) to run
    under torch.profiler, its profile kept in PROFILE; 0 for none."""
    global _on, _frames, _profile_frame
    if on:
        SPANS.clear()
        COUNTS.clear()
        DEVICE_COUNTS.clear()
        PROFILE.clear()
        _open.clear()
        _frames = 0
    _profile_frame = profile_frame if on else 0
    _on = bool(on)


def enabled() -> bool:
    return _on


def _frame_now() -> int:
    return SPANS[_open[-1]][2] if _open else 0


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof) -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    PROFILE.append(prof)


class _Span:
    __slots__ = ("name", "bounce", "index", "annotation", "profiler")

    def __init__(self, name: str, bounce):
        self.name = name
        self.bounce = bounce
        self.profiler = None

    def __enter__(self):
        global _frames
        from torch.profiler import record_function

        parent = _open[-1] if _open else -1
        if self.name == "frame":
            _frames += 1
            frame = _frames
            if frame == _profile_frame:
                self.profiler = _start_profiler()
        else:
            frame = _frame_now()
        bounce = self.bounce if self.bounce is not None else (SPANS[parent][3] if parent >= 0 else -1)
        self.annotation = record_function("crt." + self.name)
        self.annotation.__enter__()
        self.index = len(SPANS)
        _open.append(self.index)
        SPANS.append([self.name, parent, frame, bounce, time.perf_counter_ns(), 0])
        return self

    def __exit__(self, *exc):
        SPANS[self.index][5] = time.perf_counter_ns()
        _open.pop()
        self.annotation.__exit__(*exc)
        if self.profiler is not None:
            _stop_profiler(self.profiler)
        return False


def span(name: str, bounce=None):
    """A context that records span `name`; bounce is the path bounce it
    belongs to (default: its parent's, or -1)."""
    if not _on:
        return _NULL
    return _Span(name, bounce)


def sync(site: str):
    """span("sync." + site), counting one host sync: it wraps one blocking
    device-to-host read."""
    if not _on:
        return _NULL
    count("host_syncs")
    return _Span("sync." + site, None)


def count(name: str, n: int = 1) -> None:
    """Add the host integer n to counter `name` of the frame running now
    (or of the set-up)."""
    if _on:
        key = (_frame_now(), name)
        COUNTS[key] = COUNTS.get(key, 0) + int(n)


def count_on_device(name: str, value) -> None:
    """Add a 0-dim integer tensor to counter `name` at the frame's next
    read_with()."""
    if _on:
        DEVICE_COUNTS.setdefault(name, []).append(value)


def read_with(total) -> int:
    """int(total), of a 0-dim tensor. With tracing on, the tensors
    count_on_device() kept come back in the same read and are added to
    their counters."""
    if not (_on and DEVICE_COUNTS):
        return int(total)
    import torch

    names = list(DEVICE_COUNTS)
    parts = [sum(t.to(total.device) for t in DEVICE_COUNTS[n]) for n in names]
    values = torch.stack([total.reshape(()), *parts]).tolist()
    DEVICE_COUNTS.clear()
    for name, v in zip(names, values[1:]):
        count(name, v)
    return int(values[0])


def frame_summary(frames=None) -> dict:
    """What was recorded since the last call: {"frames": how many frames
    were summed, "host_ms": {span: host ms a frame of its self time, its
    duration less its child spans'}, "counts": {counter: count a frame},
    "setup_ms" and "setup_counts": the same in all outside every frame}.
    frames: the numbers of the frames to sum (default: every frame
    recorded); the others are left out. Names in the order they first
    appeared. Clears the record."""
    if _open:
        raise RuntimeError(f"frame_summary inside span {SPANS[_open[-1]][0]!r}")
    child = [0] * len(SPANS)
    for _, parent, _, _, start, end in SPANS:
        if parent >= 0:
            child[parent] += end - start
    chosen = {s[2] for s in SPANS if s[2] > 0} if frames is None else set(frames)
    n = max(len(chosen), 1)
    host, setup = {}, {}
    for (name, _, frame, _, start, end), inner in zip(SPANS, child):
        ms = (end - start - inner) / 1e6
        if frame == 0:
            setup[name] = setup.get(name, 0.0) + ms
        elif frame in chosen:
            host[name] = host.get(name, 0.0) + ms / n
    counts, setup_counts = {}, {}
    for (frame, name), c in COUNTS.items():
        if frame == 0:
            setup_counts[name] = setup_counts.get(name, 0) + c
        elif frame in chosen:
            counts[name] = counts.get(name, 0.0) + c / n
    SPANS.clear()
    COUNTS.clear()
    return {"frames": len(chosen), "host_ms": host, "counts": counts, "setup_ms": setup,
            "setup_counts": setup_counts}


def format_summary(summary: dict) -> str:
    """frame_summary()'s result as a table: a frame and in all."""
    n = summary["frames"]
    rows = []
    if summary["setup_ms"] or summary["setup_counts"]:
        rows.append("Set-up, outside every frame (host ms of self time, counters):")
        rows += [f"  {name:<24} {ms:10.3f}" for name, ms in summary["setup_ms"].items()]
        rows += [f"  {name:<24} {c:10g}" for name, c in summary["setup_counts"].items()]
    rows.append(f"Spans, host ms of self time, a frame and in all ({n} frames):")
    rows += [f"  {name:<24} {ms:10.3f} {ms * n:12.3f}" for name, ms in summary["host_ms"].items()]
    rows.append("Counters, a frame and in all:")
    rows += [f"  {name:<24} {c:10g} {c * n:12g}" for name, c in summary["counts"].items()]
    return "\n".join(rows)
