"""Baseline JPEG encoder (4:4:4, standard Annex K tables) — the encode half
of the stb_image_write role (reference util/stb_image_write.h; the decoder
lives in utils/jpeg.py). Written for the web viewer's MJPEG stream: a
1280x720 RGB frame encodes in tens of ms with vectorized numpy DCT.

Pipeline: RGB -> YCbCr (BT.601 like the decoder) -> per-component 8x8
blocks -> 2D DCT (separable, one batched matmul per side) -> quantize with
a quality-scaled Annex K table -> zigzag -> DC-differential + AC
run-length Huffman with the standard tables.
"""

from __future__ import annotations

import numpy as np

from chameleonrt_tpu_torch.utils.jpeg import ZIGZAG

# Annex K quantization tables (luminance, chrominance), natural order
_QT_LUMA = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61,
     12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56,
     14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77,
     24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101,
     72, 92, 95, 98, 112, 100, 103, 99], np.float64)
_QT_CHROMA = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99,
     18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99,
     47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99], np.float64)

# Annex K Huffman table specs: (bits[1..16], values)
_DC_LUMA = (
    [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    list(range(12)),
)
_DC_CHROMA = (
    [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    list(range(12)),
)
_AC_LUMA_BITS = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_CHROMA_BITS = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _huff_codes(bits, vals):
    """Symbol -> (code, length) from a JPEG bits/vals spec."""
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


_HC_DC = (_huff_codes(*_DC_LUMA), _huff_codes(*_DC_CHROMA))
_HC_AC = (
    _huff_codes(_AC_LUMA_BITS, _AC_LUMA_VALS),
    _huff_codes(_AC_CHROMA_BITS, _AC_CHROMA_VALS),
)

# 8-point DCT-II basis (orthonormal)
_DCT = np.zeros((8, 8))
for _k in range(8):
    for _n in range(8):
        _DCT[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16.0)
_DCT *= np.sqrt(2.0 / 8.0)
_DCT[0] *= np.sqrt(0.5)

_INV_ZIGZAG = np.argsort(ZIGZAG)  # natural index -> zigzag position


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H,W) -> (n_blocks, 8, 8), edge-replicated to multiples of 8."""
    h, w = plane.shape
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    hh, ww = plane.shape
    return (
        plane.reshape(hh // 8, 8, ww // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


def _magnitude(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """Encode an (H,W,3) uint8 RGB (or (H,W) gray) image as baseline JPEG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    h, w = img.shape[:2]

    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    # quality scaling (IJG convention)
    q = max(1, min(100, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    qts = []
    for tbl in (_QT_LUMA, _QT_CHROMA):
        qt = np.floor((tbl * scale + 50) / 100)
        qts.append(np.clip(qt, 1, 255))

    comps = []  # (quantized zigzag coeffs per block, table id)
    for plane, tid in ((y, 0), (cb, 1), (cr, 1)):
        blk = _blocks(plane) - 128.0
        coef = np.einsum("ij,bjk,lk->bil", _DCT, blk, _DCT)
        qt = qts[tid].reshape(8, 8)
        quant = np.round(coef / qt).astype(np.int32)
        zz = quant.reshape(-1, 64)[:, ZIGZAG]
        comps.append((zz, tid))

    bw = _BitWriter()
    n_blocks = comps[0][0].shape[0]
    prev_dc = [0, 0, 0]
    for bidx in range(n_blocks):
        for ci, (zz, tid) in enumerate(comps):
            block = zz[bidx]
            dc_tab, ac_tab = _HC_DC[tid], _HC_AC[tid]
            diff = int(block[0]) - prev_dc[ci]
            prev_dc[ci] = int(block[0])
            mag = _magnitude(diff)
            code, ln = dc_tab[mag]
            bw.put(code, ln)
            if mag:
                v = diff if diff >= 0 else diff + (1 << mag) - 1
                bw.put(v, mag)
            # AC: run-length of zeros + (run<<4 | size) symbols
            nz = np.nonzero(block[1:])[0]
            last = nz[-1] + 1 if nz.size else 0
            run = 0
            for k in range(1, last + 1):
                v = int(block[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    code, ln = ac_tab[0xF0]  # ZRL
                    bw.put(code, ln)
                    run -= 16
                mag = _magnitude(v)
                code, ln = ac_tab[(run << 4) | mag]
                bw.put(code, ln)
                vv = v if v >= 0 else v + (1 << mag) - 1
                bw.put(vv, mag)
                run = 0
            if last < 63:
                code, ln = ac_tab[0x00]  # EOB
                bw.put(code, ln)
    bw.flush()

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = bytearray(b"\xff\xd8")  # SOI
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid, qt in enumerate(qts):
        # DQT payload is in zigzag order; ZIGZAG maps position -> natural idx
        out += seg(0xDB, bytes([tid]) + bytes(qt.astype(np.uint8)[ZIGZAG].tolist()))
    # SOF0: 8-bit, 3 components, 4:4:4
    sof = bytearray([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3])
    for cid, tid in ((1, 0), (2, 1), (3, 1)):
        sof += bytes([cid, 0x11, tid])
    out += seg(0xC0, bytes(sof))
    for cls, tid, spec in (
        (0, 0, _DC_LUMA),
        (0, 1, _DC_CHROMA),
        (1, 0, (_AC_LUMA_BITS, _AC_LUMA_VALS)),
        (1, 1, (_AC_CHROMA_BITS, _AC_CHROMA_VALS)),
    ):
        bits, vals = spec
        out += seg(0xC4, bytes([(cls << 4) | tid]) + bytes(bits[1:]) + bytes(vals))
    sos = bytearray([3])
    for cid, tid in ((1, 0), (2, 1), (3, 1)):
        sos += bytes([cid, (tid << 4) | tid])
    sos += bytes([0, 63, 0])
    out += seg(0xDA, bytes(sos))
    out += bw.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)
