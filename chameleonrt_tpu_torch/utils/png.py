"""Minimal PNG encode/decode (pure Python + numpy + zlib).

Replaces the reference's vendored stb_image / stb_image_write for the formats
the framework needs (PNG save of frames, main.cpp:306-325; PNG texture load).
Supports 8-bit grayscale / gray+alpha / RGB / RGBA, non-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_COLOR_TYPE_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_CHANNELS_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) or (H, W, C) uint8 image as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8 data")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _CHANNELS_COLOR_TYPE:
        raise ValueError(f"unsupported channel count {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _CHANNELS_COLOR_TYPE[c], 0, 0, 0)
    # Filter type 0 (None) per scanline.
    raw = np.empty((h, 1 + w * c), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * c)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. raw is (h, 1+stride) uint8."""
    out = np.zeros((h, stride), dtype=np.uint8)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG into an (H, W, C) uint8 array. 16-bit images are
    downconverted to 8-bit; palette images are expanded."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = bytearray()
    w = h = depth = color_type = None
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if interlace:
                raise ValueError("interlaced PNG not supported")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat.extend(payload)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError("PNG missing IHDR")
    decomp = zlib.decompress(bytes(idat))
    if color_type == 3:  # palette
        nch, sample_depth = 1, depth
    else:
        nch, sample_depth = _COLOR_TYPE_CHANNELS[color_type], depth
    if sample_depth == 8:
        bpp = nch
        stride = w * nch
        raw = np.frombuffer(decomp, np.uint8).reshape(h, 1 + stride)
        out = _unfilter(raw, h, stride, bpp).reshape(h, w, nch)
    elif sample_depth == 16:
        bpp = nch * 2
        stride = w * nch * 2
        raw = np.frombuffer(decomp, np.uint8).reshape(h, 1 + stride)
        out16 = _unfilter(raw, h, stride, bpp).reshape(h, w, nch, 2)
        out = out16[..., 0]  # take high byte
    elif sample_depth in (1, 2, 4):
        # bit-packed grayscale/palette
        bits_per_line = w * sample_depth
        stride = (bits_per_line + 7) // 8
        raw = np.frombuffer(decomp, np.uint8).reshape(h, 1 + stride)
        rows = _unfilter(raw, h, stride, 1)
        unpacked = np.unpackbits(rows, axis=1)[:, :bits_per_line]
        vals = unpacked.reshape(h, w, sample_depth)
        weights = (1 << np.arange(sample_depth - 1, -1, -1)).astype(np.uint8)
        idx = (vals * weights).sum(axis=2).astype(np.uint8)
        if color_type == 3:
            out = idx[:, :, None]
        else:
            scale = 255 // ((1 << sample_depth) - 1)
            out = (idx * scale)[:, :, None]
    else:
        raise ValueError(f"unsupported PNG bit depth {depth}")
    if color_type == 3:
        rgb = palette[out[:, :, 0]]
        if trns is not None:
            alpha = np.full((h, w, 1), 255, np.uint8)
            tr = np.zeros(len(palette), np.uint8) + 255
            tr[: len(trns)] = trns
            alpha[:, :, 0] = tr[out[:, :, 0]]
            out = np.concatenate([rgb, alpha], axis=2)
        else:
            out = rgb
    return np.ascontiguousarray(out)
