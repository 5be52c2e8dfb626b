"""Baseline JPEG decoder (pure Python + numpy).

Plays the JPEG half of the reference's stb_image role (util/stb_image.h;
Sponza/San Miguel textures are JPEG-heavy). Scope matches stb's common
path: baseline sequential DCT (SOF0/SOF1), 8-bit samples, Huffman entropy
coding, grayscale or YCbCr with 4:4:4 / 4:2:2 / 4:2:0 sampling, restart
markers. Progressive JPEG raises (callers fall back to the magenta
placeholder via read_image_or_placeholder).

Entropy decoding is table-driven Python (one pass over the bitstream);
dequantized blocks are inverse-DCT'd in one batched numpy einsum per
component, so the heavy math is vectorized. Good enough for texture
loading at scene-build time; not a streaming decoder.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    np.int32,
)

# 8x8 DCT-II basis: block = C.T @ coeffs @ C
_C = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16.0) * (
            np.sqrt(1.0 / 8.0) if _k == 0 else np.sqrt(2.0 / 8.0)
        )


class _Huffman:
    """Canonical Huffman table with an 8-bit fast lookup + slow path."""

    def __init__(self, counts, symbols):
        self.lookup = np.full(256, -1, np.int32)  # (sym << 8) | length
        self.codes = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                self.codes[(length, code)] = sym
                if length <= 8:
                    lo = code << (8 - length)
                    hi = lo + (1 << (8 - length))
                    self.lookup[lo:hi] = (int(sym) << 8) | length
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment with 0xFF00
    unstuffing; stops cleanly at markers (RSTn handled by the caller)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None

    def _fill(self):
        while self.nbits <= 24:
            if self.marker is not None:
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos]
                if nxt == 0x00:
                    self.pos += 1
                else:
                    self.marker = nxt
                    self.pos -= 1
                    b = 0  # pad with zeros past the marker
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.nbits += 8

    def peek8(self) -> int:
        if self.nbits < 8:
            self._fill()
        return (self.acc >> (self.nbits - 8)) & 0xFF

    def skip(self, n: int):
        self.nbits -= n

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def huff(self, table: _Huffman) -> int:
        entry = int(table.lookup[self.peek8()])
        if entry >= 0:
            self.skip(entry & 0xFF)
            return entry >> 8
        # slow path: codes longer than 8 bits
        code = self.get(8)
        length = 8
        while length < 17:
            code = (code << 1) | self.get(1)
            length += 1
            sym = table.codes.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("invalid Huffman code")

    def restart(self):
        """Discard padding bits and consume the RST marker."""
        self.nbits = 0
        self.acc = 0
        if self.marker is None:
            # scan to the marker (skips any not-yet-buffered pad bytes)
            while self.data[self.pos] != 0xFF or self.data[self.pos + 1] == 0x00:
                self.pos += 1
        self.pos += 2  # consume FF Dn
        self.marker = None


def _extend(v: int, n: int) -> int:
    """JPEG signed magnitude decode (ITU T.81 F.2.2.1)."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def _next_marker(data: bytes, pos: int) -> int:
    """Position of the next real marker at/after pos (skips entropy-coded
    data, 0xFF00 stuffing, and RST markers)."""
    n = len(data)
    while pos < n - 1:
        if data[pos] == 0xFF:
            m = data[pos + 1]
            if m != 0x00 and m != 0xFF and not (0xD0 <= m <= 0xD7):
                return pos
            pos += 2
        else:
            pos += 1
    return n


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline-sequential (SOF0/1) or progressive (SOF2) JPEG
    byte string to (H, W, C) uint8 (C = 1 or 3).

    Progressive support (the reference decodes both via stb,
    util/stb_image.h): every scan — DC first/refine with successive
    approximation, AC first/refine with spectral selection and EOB runs —
    accumulates into per-component dense coefficient planes; dequant +
    batched IDCT + chroma upsampling run once at EOI over the final
    coefficients (ITU T.81 Annex G)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}
    dc_tables = {}
    ac_tables = {}
    frame = None
    planes = None
    restart_interval = 0
    progressive = False

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seg_len,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2 : pos + seg_len]
        if marker == 0xDB:  # DQT
            s = 0
            while s < len(seg):
                pq, tq = seg[s] >> 4, seg[s] & 0xF
                s += 1
                if pq:
                    tbl = np.frombuffer(seg, ">u2", 64, s).astype(np.int32)
                    s += 128
                else:
                    tbl = np.frombuffer(seg, np.uint8, 64, s).astype(np.int32)
                    s += 64
                qt[tq] = tbl
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 progressive
            progressive = marker == 0xC2
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise ValueError(f"unsupported JPEG precision {prec}")
            comps = []
            for c in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * c)
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 0xF, "tq": tq})
            frame = {"w": w, "h": h, "comps": comps}
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            frame["hmax"], frame["vmax"] = hmax, vmax
            frame["mcux"] = -(-w // (8 * hmax))
            frame["mcuy"] = -(-h // (8 * vmax))
            planes = [
                np.zeros((frame["mcuy"] * c["v"] * frame["mcux"] * c["h"], 64), np.int32)
                for c in comps
            ]
            for ci, c in enumerate(comps):
                c["index"] = ci
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(
                f"unsupported JPEG type (marker 0xFF{marker:02X}; baseline "
                "sequential SOF0/SOF1 and progressive SOF2 are implemented)"
            )
        elif marker == 0xC4:  # DHT
            s = 0
            while s < len(seg):
                tc, th = seg[s] >> 4, seg[s] & 0xF
                counts = list(seg[s + 1 : s + 17])
                total = sum(counts)
                symbols = list(seg[s + 17 : s + 17 + total])
                table = _Huffman(counts, symbols)
                (dc_tables if tc == 0 else ac_tables)[th] = table
                s += 17 + total
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = seg[0]
            scan = []
            for c in range(ns):
                cs, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                comp = next(x for x in frame["comps"] if x["id"] == cs)
                scan.append(
                    (comp, dc_tables.get(tt >> 4), ac_tables.get(tt & 0xF))
                )
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 0xF
            scan_start = pos + seg_len
            _decode_scan_into(
                data, scan_start, frame, scan, planes,
                ss, se, ah, al, restart_interval,
            )
            pos = _next_marker(data, scan_start)
            continue
        pos += seg_len

    if planes is None:
        raise ValueError("no SOS segment found")
    return _assemble(frame, planes, qt)


def _decode_scan_into(
    data, pos, frame, scan, planes, ss, se, ah, al, restart_interval
):
    """Decode one entropy-coded scan into the coefficient planes. Handles
    sequential full-band scans, progressive DC first/refine (interleaved
    or not), and progressive AC first/refine (always single-component)."""
    br = _BitReader(data, pos)
    zz = ZIGZAG
    mcux = frame["mcux"]
    dc_scan = ss == 0
    ac_scan = not dc_scan
    full_scan = ss == 0 and se == 63 and ah == 0

    if ac_scan and len(scan) != 1:
        raise ValueError("progressive AC scan must have a single component")

    if len(scan) == 1 and not full_scan:
        # non-interleaved: iterate the component's own block raster
        comp, dct, act = scan[0]
        ci = comp["index"]
        cw = -(-frame["w"] * comp["h"] // (8 * frame["hmax"]))
        chh = -(-frame["h"] * comp["v"] // (8 * frame["vmax"]))
        n_blocks = cw * chh
        pred = 0
        eobrun = 0
        for b in range(n_blocks):
            if restart_interval and b and b % restart_interval == 0:
                br.restart()
                pred = 0
                eobrun = 0
            by, bx = divmod(b, cw)
            coeffs = planes[ci][by * (mcux * comp["h"]) + bx]
            if dc_scan:
                if ah == 0:
                    ssss = br.huff(dct)
                    pred += _extend(br.get(ssss), ssss)
                    coeffs[0] = pred << al
                else:
                    if br.get(1):
                        coeffs[0] |= 1 << al
            elif ah == 0:
                eobrun = _ac_first(br, act, coeffs, zz, ss, se, al, eobrun)
            else:
                eobrun = _ac_refine(br, act, coeffs, zz, ss, se, al, eobrun)
        return

    # interleaved MCU order (sequential full scans and interleaved DC scans)
    mcuy = frame["mcuy"]
    n_mcu = mcux * mcuy
    pred = [0] * len(scan)
    for m in range(n_mcu):
        if restart_interval and m and m % restart_interval == 0:
            br.restart()
            pred = [0] * len(scan)
        my, mx = divmod(m, mcux)
        for si, (comp, dct, act) in enumerate(scan):
            ch, cv = comp["h"], comp["v"]
            ci = comp["index"]
            for b in range(ch * cv):
                by, bx = divmod(b, ch)
                row = (my * cv + by) * (mcux * ch) + (mx * ch + bx)
                coeffs = planes[ci][row]
                if full_scan:
                    # DC
                    ssss = br.huff(dct)
                    pred[si] += _extend(br.get(ssss), ssss)
                    coeffs[0] = pred[si]
                    # AC
                    k = 1
                    while k < 64:
                        rs = br.huff(act)
                        r, s = rs >> 4, rs & 0xF
                        if s == 0:
                            if r == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += r
                        if k > 63:
                            raise ValueError("AC coefficient index overflow")
                        coeffs[zz[k]] = _extend(br.get(s), s)
                        k += 1
                elif ah == 0:  # progressive DC first
                    ssss = br.huff(dct)
                    pred[si] += _extend(br.get(ssss), ssss)
                    coeffs[0] = pred[si] << al
                else:  # progressive DC refine
                    if br.get(1):
                        coeffs[0] |= 1 << al


def _ac_first(br, act, coeffs, zz, ss, se, al, eobrun):
    """Progressive AC initial scan for one block (T.81 G.1.2.2)."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = br.huff(act)
        r, s = rs >> 4, rs & 0xF
        if s == 0:
            if r < 15:
                eobrun = (1 << r) - 1
                if r:
                    eobrun += br.get(r)
                break
            k += 16
            continue
        k += r
        if k > se:
            raise ValueError("AC coefficient index overflow in progressive scan")
        coeffs[zz[k]] = _extend(br.get(s), s) << al
        k += 1
    return eobrun


def _ac_refine(br, act, coeffs, zz, ss, se, al, eobrun):
    """Progressive AC refinement scan for one block (T.81 G.1.2.3): emit
    correction bits for already-nonzero coefficients, insert newly
    significant ones."""
    p1 = 1 << al
    m1 = -(1 << al)
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = br.huff(act)
            r, s = rs >> 4, rs & 0xF
            if s == 0:
                if r < 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.get(r)
                    break
                val = 0  # ZRL: skip 16 zero-history coefficients
            else:
                val = p1 if br.get(1) else m1
            while k <= se:
                c = zz[k]
                if coeffs[c] != 0:
                    if br.get(1) and (coeffs[c] & p1) == 0:
                        coeffs[c] += p1 if coeffs[c] >= 0 else m1
                else:
                    if r == 0:
                        if val:
                            coeffs[c] = val
                        k += 1
                        break
                    r -= 1
                k += 1
    if eobrun > 0:
        while k <= se:
            c = zz[k]
            if coeffs[c] != 0:
                if br.get(1) and (coeffs[c] & p1) == 0:
                    coeffs[c] += p1 if coeffs[c] >= 0 else m1
            k += 1
        eobrun -= 1
    return eobrun


def _assemble(frame, planes, qt):
    """Dequant + batched IDCT per component, assemble + upsample, color
    convert."""
    w, h = frame["w"], frame["h"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    mcux, mcuy = frame["mcux"], frame["mcuy"]
    comps = frame["comps"]
    out = np.empty((h, w, len(comps)), np.uint8)
    for ci, comp in enumerate(comps):
        ch, cv = comp["h"], comp["v"]
        bw = mcux * ch
        bh = mcuy * cv
        q = qt[comp["tq"]][np.argsort(ZIGZAG)]  # natural-order quant table
        blocks = planes[ci].astype(np.float64) * q[None, :]
        blocks = blocks.reshape(bh, bw, 8, 8)
        pix = np.einsum("ki,mnkl,lj->minj", _C, blocks, _C, optimize=True)
        plane = pix.reshape(bh * 8, bw * 8) + 128.0
        # upsample to full resolution (sample replication, like stb's default)
        if ch != hmax or cv != vmax:
            plane = np.repeat(np.repeat(plane, vmax // cv, 0), hmax // ch, 1)
        out[:, :, ci] = np.clip(plane[:h, :w], 0, 255).astype(np.uint8)

    if len(comps) == 1:
        return out
    if len(comps) != 3:
        raise ValueError(f"unsupported JPEG component count {len(comps)}")
    # YCbCr -> RGB (ITU BT.601, matching stb)
    y = out[:, :, 0].astype(np.float32)
    cb = out[:, :, 1].astype(np.float32) - 128.0
    cr = out[:, :, 2].astype(np.float32) - 128.0
    rgb = np.stack(
        [
            y + 1.402 * cr,
            y - 0.344136 * cb - 0.714136 * cr,
            y + 1.772 * cb,
        ],
        axis=-1,
    )
    return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
