"""Texture/framebuffer image IO dispatch (PNG, TGA, BMP, baseline JPEG).

Plays the role of the reference's stb_image/stb_image_write usage
(util/material.cpp Image load, main.cpp:306-325 frame save).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from chameleonrt_tpu_torch.utils import png


def read_tga(path: str) -> np.ndarray:
    """Read uncompressed or RLE true-color/grayscale TGA."""
    with open(path, "rb") as f:
        data = f.read()
    (
        id_len,
        cmap_type,
        img_type,
        _cmap_first,
        _cmap_len,
        _cmap_bpp,
        _x0,
        _y0,
        w,
        h,
        bpp,
        desc,
    ) = struct.unpack_from("<BBBHHBHHHHBB", data, 0)
    if cmap_type != 0:
        raise ValueError("color-mapped TGA not supported")
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"unsupported TGA image type {img_type}")
    nch = bpp // 8
    pos = 18 + id_len
    count = w * h * nch
    if img_type in (2, 3):
        pix = np.frombuffer(data, np.uint8, count, pos).copy()
    else:  # RLE
        out = np.empty(count, np.uint8)
        oi = 0
        buf = memoryview(data)
        while oi < count:
            hdr = buf[pos]
            pos += 1
            n = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run
                out[oi : oi + n * nch] = np.tile(
                    np.frombuffer(buf, np.uint8, nch, pos), n
                )
                pos += nch
            else:  # literal
                out[oi : oi + n * nch] = np.frombuffer(buf, np.uint8, n * nch, pos)
                pos += n * nch
            oi += n * nch
        pix = out
    img = pix.reshape(h, w, nch)
    if nch >= 3:  # BGR(A) -> RGB(A)
        img = img[:, :, [2, 1, 0] + ([3] if nch == 4 else [])]
    if not (desc & 0x20):  # bottom-up origin
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    (pix_off,) = struct.unpack_from("<I", data, 10)
    (hdr_size, w, h, _planes, bpp, comp) = struct.unpack_from("<IiiHHI", data, 14)
    if comp != 0 or bpp not in (24, 32):
        raise ValueError("only uncompressed 24/32-bit BMP supported")
    nch = bpp // 8
    flip = h > 0
    h = abs(h)
    row_stride = (w * nch + 3) & ~3
    rows = np.frombuffer(data, np.uint8, row_stride * h, pix_off).reshape(h, row_stride)
    img = rows[:, : w * nch].reshape(h, w, nch)
    img = img[:, :, [2, 1, 0] + ([3] if nch == 4 else [])]
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_image(path: str) -> np.ndarray:
    """Read an image file into an (H, W, C) uint8 array."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return png.read_png(path)
    if ext == ".tga":
        return read_tga(path)
    if ext == ".bmp":
        return read_bmp(path)
    if ext in (".jpg", ".jpeg"):
        from chameleonrt_tpu_torch.utils import jpeg

        return jpeg.read_jpeg(path)
    raise ValueError(f"unsupported image format: {path}")


def read_image_or_placeholder(path: str, warn: bool = True) -> np.ndarray:
    """Read an image; on failure return a 4x4 magenta placeholder (keeps scene
    loading robust when a texture codec, e.g. JPEG, is unavailable)."""
    try:
        return read_image(path)
    except Exception as e:  # noqa: BLE001
        if warn:
            print(f"Warning: failed to load texture {path}: {e}; using placeholder")
        tex = np.zeros((4, 4, 3), np.uint8)
        tex[:, :, 0] = 255
        tex[:, :, 2] = 255
        return tex


def write_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        png.write_png(path, img)
    else:
        raise ValueError(f"unsupported output image format: {path}")
