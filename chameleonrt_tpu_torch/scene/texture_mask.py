"""Textured-parameter bit encoding, shared verbatim by every backend
(reference util/texture_channel_mask.h:16-23).

Any float material parameter doubles as a texture handle when its sign bit is
set: bits [29:30] select the texture channel (ignored for base_color, which
uses all channels), bits [0:28] carry the texture id.
"""

from __future__ import annotations

import numpy as np

TEXTURED_PARAM_MASK = np.uint32(0x80000000)


def is_textured(bits) -> np.ndarray:
    """True where the float bit pattern is a texture handle."""
    return (np.asarray(bits, dtype=np.uint32) & TEXTURED_PARAM_MASK) != 0


def texture_channel(bits) -> np.ndarray:
    return (np.asarray(bits, dtype=np.uint32) >> np.uint32(29)) & np.uint32(0x3)


def texture_id(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32) & np.uint32(0x1FFFFFFF)


def make_texture_handle(tex_id: int, channel: int = 0) -> float:
    """Encode (tex_id, channel) as the float whose bits carry the handle."""
    bits = np.uint32(TEXTURED_PARAM_MASK)
    bits |= np.uint32(tex_id) & np.uint32(0x1FFFFFFF)
    bits |= (np.uint32(channel) & np.uint32(0x3)) << np.uint32(29)
    return float(bits.view(np.float32))


def float_bits(x) -> np.ndarray:
    """Reinterpret float32 values as uint32 bit patterns."""
    return np.asarray(x, dtype=np.float32).view(np.uint32)
