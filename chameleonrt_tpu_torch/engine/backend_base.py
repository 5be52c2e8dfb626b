"""Shared backend machinery (torch): the counterpart of
chameleonrt_tpu/engine/backend_base.py.

The RenderBackend contract (initialize / set_scene / render, RenderStats
with rays/s) over a device-resident accumulation buffer. Only the
tonemapped sRGB8 image comes back to the host, and only when asked.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from chameleonrt_tpu.core.backend import RenderBackend, RenderStats
from chameleonrt_tpu.scene.types import Scene
from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.engine.device_scene import FlatScene, SceneMeta
from chameleonrt_tpu_torch.ops import camera as camera_ops
from chameleonrt_tpu_torch.ops.tonemap import linear_to_srgb_u8


class TorchRenderBackend(RenderBackend):
    """Base of the torch backends; subclasses provide the scene tables and
    the trace functions."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        self.fb_width = 0
        self.fb_height = 0
        self.frame_id = 0
        self.flat: Optional[FlatScene] = None
        self.meta: Optional[SceneMeta] = None
        self._accum = None
        self._trace = None
        self._pixels = None

    # -- subclass hooks -------------------------------------------------------
    def prepare_scene(self, scene: Scene):
        raise NotImplementedError

    def make_trace_fns(self, meta: SceneMeta):
        raise NotImplementedError

    # -- RenderBackend contract ---------------------------------------------
    def initialize(self, fb_width: int, fb_height: int) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: this backend renders on an NVIDIA GPU")
        self.fb_width = int(fb_width)
        self.fb_height = int(fb_height)
        self.img = np.zeros((self.fb_height, self.fb_width, 4), np.uint8)
        self._accum = None
        self.frame_id = 0
        ys, xs = torch.meshgrid(
            torch.arange(self.fb_height, device=self.device),
            torch.arange(self.fb_width, device=self.device),
            indexing="ij",
        )
        self._pixels = (xs.reshape(-1), ys.reshape(-1))

    def set_scene(self, scene: Scene) -> None:
        self.samples_per_pixel = int(scene.samples_per_pixel)
        self.flat, self.meta = self.prepare_scene(scene)
        self._trace = self.make_trace_fns(self.meta)
        self.frame_id = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
            self._accum = torch.zeros((H, W, 3), dtype=torch.float32, device=self.device)
        view = camera_ops.compute_view_params(pos, dir, up, fov_y, W, H)
        trace_closest, trace_any = self._trace

        self._sync()
        t0 = time.perf_counter()
        illum, rays = path_tracer.render_pixels(
            self.flat, self.meta, trace_closest, trace_any, view, self.frame_id,
            self._pixels[0], self._pixels[1], W, H, self.samples_per_pixel,
        )
        self._accum = path_tracer.progressive_accum(
            self._accum, illum.reshape(H, W, 3), self.frame_id
        )
        rays = int(rays)  # waits for the frame's ray count
        self._sync()
        dt = time.perf_counter() - t0

        stats = RenderStats(
            render_time=dt * 1e3,
            rays_per_second=rays / dt if dt > 0 else 0.0,
            rays_traced=rays,
        )
        if readback_framebuffer:
            self.img = linear_to_srgb_u8(self._accum).cpu().numpy()
        self.frame_id += 1
        return stats

    # -- checkpoint / resume --------------------------------------------------
    def save_state(self, path: str) -> None:
        """Accumulation buffer and frame counter to .npz (the JAX backend's
        format, so either package can resume the other's render)."""
        if self._accum is None:
            raise RuntimeError("nothing to save: no render state")
        np.savez_compressed(
            path,
            accum=self._accum.cpu().numpy(),
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
        self._accum = torch.as_tensor(accum, dtype=torch.float32, device=self.device)
        self.frame_id = frame_id
        self.img = linear_to_srgb_u8(self._accum).cpu().numpy()
