"""The renderer backend contract.

Mirrors the reference's abstract RenderBackend
(reference util/render_backend.h:12-32): ``name`` / ``initialize`` /
``set_scene`` / ``render`` plus a host framebuffer of sRGB8 pixels, and
RenderStats {render_time, rays_per_second} (render_backend.h:7-10).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from chameleonrt_tpu_torch.scene.types import Scene


@dataclass
class RenderStats:
    """Per-frame render statistics (reference util/render_backend.h:7-10).

    render_time: device-side render time for the frame, in milliseconds.
    rays_per_second: total rays traced per second (primary + shadow +
    secondary), when ray-stat reporting is enabled; 0 otherwise.
    """

    render_time: float = 0.0
    rays_per_second: float = 0.0
    rays_traced: int = 0


@dataclass
class CameraPose:
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 5.0], np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0], np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_y: float = 65.0


class RenderBackend(abc.ABC):
    """Abstract renderer. Owns the host framebuffer ``img`` (H, W, 4) uint8
    (sRGB8+alpha, matching reference util/render_backend.h:21) and the
    samples-per-pixel count."""

    def __init__(self):
        self.img: np.ndarray = np.zeros((0, 0, 4), dtype=np.uint8)
        self.samples_per_pixel: int = 1

    @property
    @abc.abstractmethod
    def name(self) -> str:
        """Display name of the backend."""

    @abc.abstractmethod
    def initialize(self, fb_width: int, fb_height: int) -> None:
        """Allocate framebuffer / accumulation buffers for the given size."""

    @abc.abstractmethod
    def set_scene(self, scene: Scene) -> None:
        """Upload the scene and build device acceleration structures."""

    @abc.abstractmethod
    def render(
        self,
        pos: np.ndarray,
        dir: np.ndarray,
        up: np.ndarray,
        fov_y: float,
        camera_changed: bool,
        readback_framebuffer: bool = True,
    ) -> RenderStats:
        """Render one progressive frame; accumulate into the running average
        (restart when camera_changed). When readback_framebuffer, refresh
        ``self.img`` with the tonemapped sRGB8 image."""
