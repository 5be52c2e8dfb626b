"""Display layer — presentation of the rendered framebuffer; a copy of
chameleonrt_tpu/display/display.py with the port's imports.

The reference's abstract Display (util/display/display.h:7-19:
gpu_brand/name/resize/new_frame/display(RenderBackend*)) is fronted by
GL/Vulkan/DX/Metal swapchain implementations. GPU servers are often
headless, so the implementations here present to what a headless host
has: a PNG frame sequence (the `-validation` pathway generalized) and an
ANSI truecolor half-block terminal preview for interactive sessions.
"""

from __future__ import annotations

import abc
import os
import sys

import numpy as np

from chameleonrt_tpu_torch.core.backend import RenderBackend
from chameleonrt_tpu_torch.utils.util import get_device_brand


class Display(abc.ABC):
    """Abstract display (reference util/display/display.h:7-19)."""

    def gpu_brand(self) -> str:
        return get_device_brand()

    @abc.abstractmethod
    def name(self) -> str:
        ...

    def resize(self, fb_width: int, fb_height: int) -> None:
        self.width = fb_width
        self.height = fb_height

    def new_frame(self) -> None:
        pass

    @abc.abstractmethod
    def display(self, renderer: RenderBackend) -> None:
        """Present the renderer's framebuffer."""


class PngSequenceDisplay(Display):
    """Writes each presented frame as <prefix>-f<N>.png."""

    def __init__(self, prefix: str = "frame"):
        self.prefix = prefix
        self.frame = 0

    def name(self) -> str:
        return "PNG sequence"

    def display(self, renderer: RenderBackend) -> None:
        from chameleonrt_tpu_torch.utils.png import write_png

        write_png(f"{self.prefix}-f{self.frame}.png", renderer.img)
        self.frame += 1


class AnsiDisplay(Display):
    """Terminal preview using 24-bit color half-block characters: two image
    rows per text row. The headless stand-in for the reference's windowed
    displays.

    With ``live=True`` each present rewinds the cursor over the previous
    frame and redraws in place — progressive accumulation refreshes like
    the reference's window does (main.cpp:231-380 frame loop), instead of
    scrolling one dump per frame."""

    def __init__(self, max_cols: int = 100, stream=None, live: bool = False):
        self.max_cols = max_cols
        self.stream = stream or sys.stdout
        self.live = live
        self._last_lines = 0

    def name(self) -> str:
        return "ANSI terminal"

    def display(self, renderer: RenderBackend, status: str = "") -> None:
        img = renderer.img[..., :3]
        h, w = img.shape[:2]
        step = max(1, (w + self.max_cols - 1) // self.max_cols)
        small = img[:: 2 * step, ::step]
        top = small[0::2]
        bottom = small[1::2]
        n = min(len(top), len(bottom))
        if self.live and self._last_lines:
            self.stream.write(f"\x1b[{self._last_lines}A\r")
        out = []
        for r in range(n):
            row = []
            for c in range(top.shape[1]):
                tr, tg, tb = (int(x) for x in top[r, c])
                br, bg, bb = (int(x) for x in bottom[r, c])
                row.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
                )
            out.append("".join(row) + "\x1b[0m")
        lines = n
        if status:
            out.append(f"\x1b[2K{status}")
            lines += 1
        self.stream.write("\n".join(out) + "\n")
        self.stream.flush()
        self._last_lines = lines


def make_display(kind: str, **kwargs) -> Display:
    """Display factory (the make_display plugin-table seam,
    reference util/render_plugin.h:23-41)."""
    from chameleonrt_tpu_torch.display.http_display import HttpDisplay

    kinds = {"png": PngSequenceDisplay, "ansi": AnsiDisplay, "http": HttpDisplay}
    if kind not in kinds:
        raise ValueError(f"unknown display '{kind}'; have {sorted(kinds)}")
    return kinds[kind](**kwargs)
