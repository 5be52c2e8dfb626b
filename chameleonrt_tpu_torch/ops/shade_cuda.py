"""Wrapper of S1 (csrc/shade.cu): the shading stage of one bounce for the
compacted live lanes, in one launch.

S1 replaces no Pallas kernel (the JAX package leaves shading to XLA's
fusion); it computes engine/path_tracer.py's _shade_bounce, the plain
version, lane for lane, drawing the LCG in the same order. shade_bounce
takes _shade_bounce's arguments and returns its ShadeOut. It checks its
inputs against what the kernel takes and raises on anything else. Then,
on CUDA tensors, it allocates ShadeOut's fields, launches S1 on the
current stream and device without synchronizing, and raises if the launch
fails; on CPU tensors it runs _shade_bounce instead. There is no other
fallback.

LAUNCHES counts S1's launches, so that a caller can show that a run
shaded through the kernel; the tracing counter lanes.shaded_kernel counts
the lanes it shaded.
"""

from __future__ import annotations

import ctypes

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.core import tracing

LAUNCHES = 0

# _shade_bounce's lanes and ShadeOut's fields, in order: (name, dtype,
# components; 0 for one)
_LANES = (("state", torch.int64, 0), ("orig", torch.float32, 3), ("dir", torch.float32, 3),
          ("throughput", torch.float32, 3), ("active", torch.bool, 0),
          ("hit_p", torch.float32, 3), ("hit_tri", torch.int32, 0), ("hit_inst", torch.int32, 0),
          ("hit_u", torch.float32, 0), ("hit_v", torch.float32, 0))
_OUT = ((torch.int64, 0), (torch.float32, 3), (torch.float32, 3), (torch.bool, 0),
        (torch.float32, 3), (torch.float32, 0), (torch.bool, 0), (torch.float32, 3),
        (torch.float32, 0), (torch.float32, 3), (torch.float32, 3), (torch.bool, 0))


def textured_mask(meta) -> int:
    """Bit k set where material field k (base_color, then the 11 scalars)
    may carry a texture handle; 0 in a scene without textures."""
    if not meta.has_textures:
        return 0
    fields = meta.textured_fields or (True,) * 12
    return sum(1 << k for k, on in enumerate(fields) if on)


def _check(flat, meta, lanes):
    """Validate the scene tables and the lanes against what S1 takes; raise
    on anything else."""
    R = lanes[0].shape[0]
    dev = lanes[0].device
    L = meta.num_lights
    want = [
        ("shade_rows", flat.shade_rows, torch.float32, (meta.num_tris, 32)),
        ("mat_rows", flat.mat_rows, torch.float32, (None, 16)),
        ("inst_inv", flat.inst_inv, torch.float32, (meta.num_instances, 4, 4)),
        ("inst_mat_table", flat.inst_mat_table, torch.int32, (meta.num_instances, None)),
        *((f"lights.{name}", x, torch.float32, (L,) if name in ("width", "height") else (L, 3))
          for name, x in zip(flat.lights._fields, flat.lights)),
        ("atlas", flat.atlas.atlas, torch.uint8, (None, 16)),
        ("atlas table", flat.atlas.table, torch.int32, (None, 4)),
        *((name, x, dtype, (R, k) if k else (R,)) for (name, dtype, k), x in zip(_LANES, lanes)),
    ]
    for name, x, dtype, shape in want:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the lanes are on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, x.shape)):
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if flat.shade_rows.data_ptr() % 16:
        raise ValueError("shade rows must be 16-byte aligned")
    if meta.num_lights < 1 or meta.num_instances < 1 or flat.atlas.table.shape[0] < 1:
        raise ValueError("S1 takes a scene with a light, an instance and an atlas table")


def empty_outputs(R: int, device) -> list:
    """ShadeOut's 12 fields for R lanes, uninitialized."""
    return [torch.empty((R, k) if k else (R,), dtype=dtype, device=device) for dtype, k in _OUT]


_P, _I = ctypes.c_void_p, ctypes.c_int


class Scene(ctypes.Structure):
    """crt::shade::Scene (csrc/shade_common.cuh), field for field."""
    _fields_ = [("shade_rows", _P), ("num_tris", _I), ("mat_rows", _P), ("num_mats", _I),
                ("inst_inv", _P), ("inst_mat_table", _P), ("num_instances", _I), ("g_max", _I),
                ("emission", _P), ("position", _P), ("normal", _P), ("v_x", _P), ("v_y", _P),
                ("width", _P), ("height", _P), ("num_lights", _I), ("atlas", _P),
                ("atlas_table", _P), ("num_textures", _I), ("textured", _I)]


class Lanes(ctypes.Structure):
    """crt::shade::Lanes (csrc/shade_common.cuh), field for field: the
    lanes' 9 inputs, then ShadeOut's 12 fields."""
    _fields_ = [(name, _P) for name in (
        "state", "dir", "throughput", "active", "hit_p", "hit_tri", "hit_inst", "hit_u", "hit_v",
        "state_out", "c1", "c2", "shoot1", "light_dir", "light_dist", "shoot2", "w_i2", "t_light",
        "new_tp", "cont_dir", "new_active")]


def launch_args(flat, meta, bounce: int, lanes, outs) -> list:
    """crt_shade_bounce's arguments but the stream: the scene's tables and
    counts (Scene) and the lanes but orig with the outputs (Lanes), each by
    reference, then R and the bounce."""
    atlas = flat.atlas
    scene = Scene(flat.shade_rows.data_ptr(), meta.num_tris, flat.mat_rows.data_ptr(),
                  flat.mat_rows.shape[0], flat.inst_inv.data_ptr(),
                  flat.inst_mat_table.data_ptr(), meta.num_instances,
                  flat.inst_mat_table.shape[1], *(x.data_ptr() for x in flat.lights),
                  meta.num_lights, atlas.atlas.data_ptr(), atlas.table.data_ptr(),
                  atlas.table.shape[0], textured_mask(meta))
    ptrs = [x.data_ptr() for i, x in enumerate(lanes) if i != 1]  # orig is not read
    return [ctypes.byref(scene), ctypes.byref(Lanes(*ptrs, *(x.data_ptr() for x in outs))),
            lanes[0].shape[0], bounce]


def shade_bounce(flat, meta, bounce: int, state, orig, dir, throughput, active, hit_p, hit_tri,
                 hit_inst, hit_u, hit_v):
    """S1: _shade_bounce of the given lanes. Returns its ShadeOut; on CPU
    tensors, _shade_bounce's own."""
    # engine/path_tracer.py imports this module
    from chameleonrt_tpu_torch.engine import path_tracer

    global LAUNCHES
    lanes = (state, orig, dir, throughput, active, hit_p, hit_tri, hit_inst, hit_u, hit_v)
    _check(flat, meta, lanes)
    if state.device.type == "cpu":
        return path_tracer._shade_bounce(flat, meta, bounce, *lanes)
    R = state.shape[0]
    outs = empty_outputs(R, state.device)
    if R:
        lib = _build.kernels()
        err = lib.crt_shade_bounce(
            *launch_args(flat, meta, bounce, lanes, outs),
            ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"crt_shade_bounce launch failed: {lib.crt_error_string(err).decode()}")
        LAUNCHES += 1
        tracing.count("lanes.shaded_kernel", R)
    return path_tracer.ShadeOut(*outs)
