"""Misc host utilities (reference util/util.cpp)."""

from __future__ import annotations

import numpy as np


def pretty_print_count(count: float) -> str:
    """Format a count with G/M/K suffix (reference util/util.cpp:23-36)."""
    divisor = 1.0
    suffix = ""
    if count >= 1e9:
        divisor, suffix = 1e9, "G"
    elif count >= 1e6:
        divisor, suffix = 1e6, "M"
    elif count >= 1e3:
        divisor, suffix = 1e3, "K"
    return f"{count / divisor:.2f}{suffix}"


def align_to(value: int, alignment: int) -> int:
    return ((value + alignment - 1) // alignment) * alignment


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """sRGB -> linear (reference util/util.cpp:102-109)."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """linear -> sRGB (reference util/util.cpp:111-116)."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(
        x <= 0.0031308, 12.92 * x, 1.055 * np.maximum(x, 1e-12) ** (1.0 / 2.4) - 0.055
    ).astype(np.float32)


def luminance(c: np.ndarray) -> np.ndarray:
    """Rec.709 luminance (reference util/util.cpp:118-121)."""
    c = np.asarray(c, dtype=np.float32)
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]



def get_device_brand() -> str:
    """Device provenance string (the GPU analogue of get_cpu_brand,
    reference util/util.cpp:74-100): the first card's name and the number
    of cards, or "no CUDA device"."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
