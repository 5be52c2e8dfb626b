"""Shared backend machinery (torch): the counterpart of
chameleonrt_tpu/engine/backend_base.py.

The RenderBackend contract (initialize / set_scene / render, RenderStats
with rays/s) over a device-resident accumulation buffer. Only the
tonemapped sRGB8 image comes back to the host, and only when asked. With
more than one device in its mesh, a backend splits the framebuffer rows
into shards (parallel/sharded.py); its buffer is then a list of shards.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from chameleonrt_tpu_torch.core import tracing
from chameleonrt_tpu_torch.core.backend import RenderBackend, RenderStats
from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.engine.device_scene import FlatScene, SceneMeta, check_scene
from chameleonrt_tpu_torch.engine.trace_bvh import blas_bytes
from chameleonrt_tpu_torch.ops import camera as camera_ops
from chameleonrt_tpu_torch.ops.tonemap import linear_to_srgb_u8
from chameleonrt_tpu_torch.parallel import sharded
from chameleonrt_tpu_torch.scene.types import Scene


class TorchRenderBackend(RenderBackend):
    """Base of the torch backends; subclasses provide the scene tables and
    the trace functions."""

    def __init__(self, device="cuda", devices=0, rebalance: bool = False):
        """devices: 0 or 1 renders on `device` alone; -1 splits the
        framebuffer rows over every CUDA device, N > 1 over min(N,
        available) of them (the JAX package's `devices`; a CPU backend has
        one); a list of devices is the mesh itself, in which a device may
        appear more than once (several shards on one card, or on the
        CPU). rebalance: with more than one shard, move active rays
        between hypercube-paired shards every bounce."""
        super().__init__()
        self.device = torch.device(device)
        self.devices_requested = devices
        self.rebalance = rebalance
        self.fb_width = 0
        self.fb_height = 0
        self.frame_id = 0
        self.flat: Optional[FlatScene] = None
        self.meta: Optional[SceneMeta] = None
        self._accum = None
        self._trace = None
        self._pixels = None
        self._mesh = self._make_mesh()
        self._flats = None  # the scene on each device of the mesh
        self._step = None  # the sharded frame step, built at the first render

    def _make_mesh(self):
        want = self.devices_requested
        if isinstance(want, (list, tuple)):
            return sharded.make_mesh(want)
        if want in (0, 1) or self.device.type != "cuda":
            return [self.device]
        avail = torch.cuda.device_count()
        n = avail if want < 0 else min(want, avail)
        return sharded.make_mesh([torch.device("cuda", i) for i in range(max(n, 1))])

    def _n_devices(self) -> int:
        return len(self._mesh)

    def _accum_height(self) -> int:
        return sharded.padded_height(self.fb_height, self._n_devices())

    def _fresh_accum(self):
        if self._n_devices() == 1:
            return torch.zeros((self.fb_height, self.fb_width, 3), dtype=torch.float32,
                               device=self.device)
        accum = torch.zeros((self._accum_height(), self.fb_width, 3), dtype=torch.float32,
                            device=self._mesh[0])
        return sharded.shard_accum(accum, self._mesh)

    # -- subclass hooks -------------------------------------------------------
    def prepare_scene(self, scene: Scene):
        raise NotImplementedError

    def make_trace_fns(self, meta: SceneMeta, flat: Optional[FlatScene] = None):
        """(trace_closest, trace_any) for the scene's tables on flat's
        device (default: self.flat)."""
        raise NotImplementedError

    # -- RenderBackend contract ---------------------------------------------
    def initialize(self, fb_width: int, fb_height: int) -> None:
        if any(d.type == "cuda" for d in (self.device, *self._mesh)) and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: this backend renders on an NVIDIA GPU")
        self.fb_width = int(fb_width)
        self.fb_height = int(fb_height)
        self.img = np.zeros((self.fb_height, self.fb_width, 4), np.uint8)
        self._accum = None
        self._step = None
        self.frame_id = 0
        ys, xs = torch.meshgrid(
            torch.arange(self.fb_height, device=self.device),
            torch.arange(self.fb_width, device=self.device),
            indexing="ij",
        )
        self._pixels = (xs.reshape(-1), ys.reshape(-1))

    def set_scene(self, scene: Scene) -> None:
        """Raises TypeError on a Scene that is not the port's own class."""
        with tracing.span("scene.set"):
            check_scene(scene)
            self.samples_per_pixel = int(scene.samples_per_pixel)
            with tracing.span("scene.set.tables"):
                self.flat, self.meta = self.prepare_scene(scene)
                tracing.count("tables.instances", self.meta.num_instances)
                tracing.count("tables.triangles", self.meta.num_tris)
                tracing.count("tables.bytes", blas_bytes(self.flat.blas))
            with tracing.span("scene.set.trace_fns"):
                self._trace = self.make_trace_fns(self.meta)
            self._step = None
            self.frame_id = 0

    def _build_step(self):
        """The sharded frame step: the scene and one set of trace
        functions on each distinct device of the mesh."""
        self._flats = sharded.replicate_scene(self.flat, self._mesh)
        traces = {dev: self._trace if flat is self.flat else self.make_trace_fns(self.meta, flat)
                  for dev, flat in self._flats.items()}
        return sharded.make_sharded_render_step(
            self.meta, traces, self._mesh, self.fb_width, self.fb_height,
            self.samples_per_pixel, rebalance=self.rebalance,
        )

    def _sync(self):
        for dev in dict.fromkeys((self.device, *self._mesh)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _tonemap(self) -> np.ndarray:
        """The sRGB8 image: each shard tonemapped on its device, the shards
        stacked and the padding rows cropped."""
        if self._n_devices() == 1:
            return linear_to_srgb_u8(self._accum).cpu().numpy()
        return np.concatenate([linear_to_srgb_u8(a).cpu().numpy()
                               for a in self._accum])[: self.fb_height]

    def framebuffer(self) -> torch.Tensor:
        """The (H, W, 3) accumulation buffer, the shards stacked on the
        first device and the padding rows cropped."""
        if self._accum is None:
            raise RuntimeError("nothing rendered yet")
        if self._n_devices() == 1:
            return self._accum
        home = self._mesh[0]
        return torch.cat([a.to(home) for a in self._accum])[: self.fb_height]

    def render(self, pos, dir, up, fov_y: float, camera_changed: bool,
               readback_framebuffer: bool = True) -> RenderStats:
        """One progressive frame. render_time is the host time from launch
        to the end of the frame's device work, in milliseconds."""
        if self.flat is None:
            raise RuntimeError("set_scene must be called before render")
        if camera_changed:
            self.frame_id = 0
        W, H = self.fb_width, self.fb_height
        if self.frame_id == 0 or self._accum is None:
            self._accum = self._fresh_accum()
        if self._n_devices() > 1 and self._step is None:
            self._step = self._build_step()
        view = camera_ops.compute_view_params(pos, dir, up, fov_y, W, H)

        self._sync()
        t0 = time.perf_counter()
        with tracing.span("frame"):
            if self._step is not None:
                self._accum, rays = self._step(self._flats, view, self._accum, self.frame_id)
            else:
                trace_closest, trace_any = self._trace
                illum, rays = path_tracer.render_pixels(
                    self.flat, self.meta, trace_closest, trace_any, view, self.frame_id,
                    self._pixels[0], self._pixels[1], W, H, self.samples_per_pixel,
                )
                self._accum = path_tracer.progressive_accum(
                    self._accum, illum.reshape(H, W, 3), self.frame_id
                )
            with tracing.sync("frame.rays"):
                rays = tracing.read_with(rays)  # waits for the frame's ray count
            self._sync()
            dt = time.perf_counter() - t0

            stats = RenderStats(
                render_time=dt * 1e3,
                rays_per_second=rays / dt if dt > 0 else 0.0,
                rays_traced=rays,
            )
            if readback_framebuffer:
                with tracing.span("frame.readback"):
                    self.img = self._tonemap()
        self.frame_id += 1
        return stats

    # -- checkpoint / resume --------------------------------------------------
    def save_state(self, path: str) -> None:
        """Accumulation buffer and frame counter to .npz (the JAX backend's
        format, so either package can resume the other's render, on any
        number of devices: the padding rows are cropped)."""
        if self._accum is None:
            raise RuntimeError("nothing to save: no render state")
        np.savez_compressed(
            path,
            accum=self.framebuffer().cpu().numpy(),
            frame_id=np.int64(self.frame_id),
            spp=np.int64(self.samples_per_pixel),
        )

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            accum = data["accum"]
            frame_id = int(data["frame_id"])
        if accum.shape != (self.fb_height, self.fb_width, 3):
            raise ValueError(
                f"checkpoint resolution {accum.shape[:2]} does not match "
                f"framebuffer {(self.fb_height, self.fb_width)}"
            )
        if self._n_devices() == 1:
            self._accum = torch.as_tensor(accum, dtype=torch.float32, device=self.device)
        else:
            pad = np.zeros((self._accum_height() - accum.shape[0], *accum.shape[1:]), np.float32)
            self._accum = sharded.shard_accum(
                torch.as_tensor(np.concatenate([accum, pad]), dtype=torch.float32), self._mesh
            )
        self.frame_id = frame_id
        self.img = self._tonemap()
