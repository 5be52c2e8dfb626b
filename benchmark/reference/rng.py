"""Per-pixel LCG random numbers of the plain reference: a frozen copy of
chameleonrt_tpu_torch/ops/rng.py (ChameleonRT's lcg_rng.ih).

torch has little uint32 arithmetic, so a state is an int64 tensor holding a
value in [0, 2**32). Every product is split into two partial products below
2**48 and masked back to 32 bits, so nothing overflows int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M = 5
_N = 0xE6546B64

_LCG_MUL = 1664525
_LCG_ADD = 1013904223

_TWO_M32 = 2.0**-32


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) and a constant c < 2**32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def murmur_hash3_mix(hash_, k):
    """One murmur3 mix round (reference lcg_rng.ih:8-25)."""
    k = _mul32(k, _C1)
    k = _rotl(k, 15)
    k = _mul32(k, _C2)
    h = hash_ ^ k
    return (_mul32(_rotl(h, 13), _M) + _N) & MASK32


def murmur_hash3_finalize(h):
    """murmur3 avalanche finalizer (reference lcg_rng.ih:27-36)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def get_rng(pixel_id, frame_id):
    """Seed an LCG state per lane (lcg_rng.ih:51-59). pixel_id and frame_id
    are int64 tensors (or a Python int for frame_id) in [0, 2**32)."""
    pixel_id = pixel_id.to(torch.int64) & MASK32
    if isinstance(frame_id, int):
        frame_id = torch.full_like(pixel_id, frame_id & MASK32)
    else:
        frame_id = frame_id.to(torch.int64) & MASK32
    state = murmur_hash3_mix(torch.zeros_like(pixel_id), pixel_id)
    state = murmur_hash3_mix(state, frame_id)
    return murmur_hash3_finalize(state)


def lcg_random(state):
    """Advance the LCG (lcg_rng.ih:38-44). Returns (new_state, raw draw)."""
    state = (_mul32(state, _LCG_MUL) + _LCG_ADD) & MASK32
    return state, state


def lcg_randomf(state):
    """Uniform float in [0, 1]: the u32 draw rounds to float32 before the
    2**-32 scale (lcg_rng.ih:46-49), so it can return exactly 1.0, as the
    reference does. Returns (new_state, float32 draw)."""
    state, bits = lcg_random(state)
    return state, bits.to(torch.float32) * _TWO_M32


def lcg_randomf2(state):
    """Two consecutive uniform draws as (state, (..., 2) tensor)."""
    state, a = lcg_randomf(state)
    state, b = lcg_randomf(state)
    return state, torch.stack([a, b], dim=-1)
