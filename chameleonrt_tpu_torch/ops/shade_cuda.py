"""S1 (csrc/shade.cu) and its plain version: the shading stage of one
bounce for the compacted live lanes, in one launch.

S1 replaces no Pallas kernel (the JAX package leaves shading to XLA's
fusion); it computes _shade_bounce, the plain version below, lane for
lane, drawing the LCG in the same order. shade_bounce takes
_shade_bounce's arguments and returns its ShadeOut. It checks its inputs
against what the kernel takes and raises on anything else. Then, on CUDA
tensors, it allocates ShadeOut's fields, launches S1 on the current stream
and device without synchronizing, and raises if the launch fails; on CPU
tensors it runs _shade_bounce instead. There is no other fallback.

LAUNCHES counts S1's launches, so that a caller can show that a run
shaded through the kernel; the tracing counter lanes.shaded_kernel counts
the lanes it shaded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.core import tracing
from chameleonrt_tpu_torch.engine.device_scene import (
    FlatScene,
    SceneMeta,
    unpack_material,
    unpack_material_row,
)
from chameleonrt_tpu_torch.ops import bsdf as bsdf_ops
from chameleonrt_tpu_torch.ops import lights as light_ops
from chameleonrt_tpu_torch.ops import rng as rng_ops
from chameleonrt_tpu_torch.ops.math import (
    EPSILON,
    cross,
    dot,
    length,
    normalize,
    ortho_basis,
    power_heuristic,
)

LAUNCHES = 0

# _shade_bounce's lanes and ShadeOut's fields, in order: (name, dtype,
# components; 0 for one)
_LANES = (("state", torch.int64, 0), ("dir", torch.float32, 3), ("throughput", torch.float32, 3),
          ("active", torch.bool, 0), ("hit_p", torch.float32, 3), ("hit_tri", torch.int32, 0),
          ("hit_inst", torch.int32, 0), ("hit_u", torch.float32, 0), ("hit_v", torch.float32, 0))
_OUT = ((torch.int64, 0), (torch.float32, 3), (torch.float32, 3), (torch.bool, 0),
        (torch.float32, 3), (torch.float32, 0), (torch.bool, 0), (torch.float32, 3),
        (torch.float32, 0), (torch.float32, 3), (torch.float32, 3), (torch.bool, 0))


class ShadeOut(NamedTuple):
    """Per-lane results of the shading stage: everything a bounce needs
    except the two occlusion traversals."""

    state: torch.Tensor
    c1: torch.Tensor  # (R, 3) light-branch contribution before visibility
    c2: torch.Tensor  # (R, 3) bsdf-branch contribution before visibility
    shoot1: torch.Tensor  # light-branch shadow-ray mask
    light_dir: torch.Tensor
    light_dist: torch.Tensor
    shoot2: torch.Tensor  # bsdf-branch shadow-ray mask
    w_i2: torch.Tensor  # bsdf-branch sample direction
    t_light: torch.Tensor
    new_throughput: torch.Tensor
    cont_dir: torch.Tensor  # continuation direction
    new_active: torch.Tensor


def _shade_bounce(
    flat: FlatScene, meta: SceneMeta, bounce: int, state, dir, throughput, active, hit_p, hit_tri,
    hit_inst, hit_u, hit_v,
) -> ShadeOut:
    """The shading stage of one bounce for a set of lanes
    (render_embree.ispc:105-181 without the occlusion calls, then the
    continuation sample and Russian roulette). Pure per-lane math: the
    plain version of S1 (shade_bounce, csrc/shade.cu), which runs it on
    CUDA lanes; this runs on CPU lanes."""
    w_o = -dir

    tri = torch.clamp(hit_tri, 0, max(meta.num_tris - 1, 0)).long()
    srow = flat.shade_rows[tri]
    e1 = srow[:, 0:3]
    e2 = srow[:, 3:6]
    ng_obj = cross(e1, e2)
    w = hit_u[..., None]
    wv = hit_v[..., None]
    uv = (1.0 - w - wv) * srow[:, 6:8] + w * srow[:, 8:10] + wv * srow[:, 10:12]
    if meta.num_instances == 1:
        # the one instance's matrix; the packed material rides in the shade row
        inv3 = flat.inst_inv[0, :3, :3]
        mat = unpack_material_row(flat, meta, srow[:, 16:32], uv)
    else:
        # each lane's own instance: its matrix, and its material by geometry slot
        inst = torch.clamp(hit_inst, 0, meta.num_instances - 1).long()
        inv3 = flat.inst_inv[inst, :3, :3]
        geom_slot = srow[:, 12].view(torch.int32).long()
        mat = unpack_material(flat, meta, flat.inst_mat_table[inst, geom_slot], uv)
    # world normal = ng_obj @ inv3 (row vector times the 3x3; ispc:287-290),
    # term by term; inv3 is (3, 3) or per lane (R, 3, 3)
    normal = normalize(
        torch.stack(
            [ng_obj[:, 0] * inv3[..., 0, j] + ng_obj[:, 1] * inv3[..., 1, j]
             + ng_obj[:, 2] * inv3[..., 2, j] for j in range(3)],
            dim=-1,
        )
    )

    # face-forward for non-transmissive materials (ispc:297-299)
    flip = (mat.specular_transmission == 0.0) & (dot(w_o, normal) < 0.0)
    n = torch.where(flip[..., None], -normal, normal)
    v_x, v_y = ortho_basis(n)

    # next-event estimation with MIS over {light sample, bsdf sample}
    state, u_l = rng_ops.lcg_randomf(state)
    R = u_l.shape[0]
    if meta.num_lights == 1:
        light = flat.lights.broadcast0(R)
    else:
        light_id = torch.clamp((u_l * meta.num_lights).to(torch.int64), max=meta.num_lights - 1)
        light = flat.lights.gather(light_id)

    # light-sampling branch (ispc:132-141)
    state, s2 = rng_ops.lcg_randomf2(state)
    light_pos = light_ops.sample_quad_light_position(light, s2)
    to_light = light_pos - hit_p
    light_dist = length(to_light)
    light_dir = normalize(to_light)
    light_pdf = light_ops.quad_light_pdf(light, light_pos, hit_p, light_dir)
    b_pdf = bsdf_ops.disney_pdf(mat, n, w_o, light_dir, v_x, v_y)

    # bsdf-sampling branch (ispc:155-166)
    state, f2, w_i, pdf2 = bsdf_ops.sample_disney_brdf(mat, n, w_o, v_x, v_y, state)
    qhit, t_light, light_pos2 = light_ops.quad_intersect(light, hit_p, w_i)
    light_pdf2 = light_ops.quad_light_pdf(light, light_pos2, hit_p, w_i)
    f2_nonzero = (f2 != 0.0).any(dim=-1)
    shoot2 = active & f2_nonzero & (pdf2 >= EPSILON) & qhit & (light_pdf2 >= EPSILON)
    # a provably zero MIS weight skips the shadow ray (ispc:142-147)
    shoot1 = active & (light_pdf >= EPSILON) & (b_pdf >= EPSILON)

    f1 = bsdf_ops.disney_brdf(mat, n, w_o, light_dir, v_x, v_y)
    w1 = power_heuristic(1.0, light_pdf, 1.0, b_pdf)
    c1 = (
        f1
        * light.emission
        * dot(light_dir, n).abs()[..., None]
        * (w1 / torch.clamp(light_pdf, min=1e-20))[..., None]
    )
    w2 = power_heuristic(1.0, pdf2, 1.0, light_pdf2)
    c2 = (
        f2
        * light.emission
        * dot(w_i, n).abs()[..., None]
        * (w2 / torch.clamp(pdf2, min=1e-20))[..., None]
    )

    # continuation (ispc:313-320)
    state, f, w_ic, pdf = bsdf_ops.sample_disney_brdf(mat, n, w_o, v_x, v_y, state)
    cont_ok = (pdf != 0.0) & (f != 0.0).any(dim=-1)
    safe_pdf = torch.where(pdf == 0.0, torch.ones_like(pdf), pdf)
    new_tp = torch.where(
        active[..., None],
        throughput * f * (dot(w_ic, n).abs() / safe_pdf)[..., None],
        throughput,
    )
    new_active = active & cont_ok

    # Russian roulette after bounce 3 (ispc:327-335)
    if bounce + 1 > 3:
        state, u_rr = rng_ops.lcg_randomf(state)
        q = torch.clamp(1.0 - new_tp.max(dim=-1).values, min=0.05)
        new_active = new_active & ~(u_rr < q)
        new_tp = torch.where(
            new_active[..., None], new_tp / torch.clamp(1.0 - q, min=1e-6)[..., None], new_tp
        )
    return ShadeOut(
        state=state, c1=c1, c2=c2, shoot1=shoot1, light_dir=light_dir,
        light_dist=light_dist, shoot2=shoot2, w_i2=w_i, t_light=t_light,
        new_throughput=new_tp, cont_dir=w_ic, new_active=new_active,
    )


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
    counts (Scene) and the lanes with the outputs (Lanes), each by
    reference, then R and the bounce."""
    atlas = flat.atlas
    scene = Scene(flat.shade_rows.data_ptr(), meta.num_tris, flat.mat_rows.data_ptr(),
                  flat.mat_rows.shape[0], flat.inst_inv.data_ptr(),
                  flat.inst_mat_table.data_ptr(), meta.num_instances,
                  flat.inst_mat_table.shape[1], *(x.data_ptr() for x in flat.lights),
                  meta.num_lights, atlas.atlas.data_ptr(), atlas.table.data_ptr(),
                  atlas.table.shape[0], textured_mask(meta))
    ptrs = (x.data_ptr() for x in (*lanes, *outs))
    return [ctypes.byref(scene), ctypes.byref(Lanes(*ptrs)), lanes[0].shape[0], bounce]


@functools.lru_cache(maxsize=None)
def _bind(lib):
    """Bind S1's entry of a loaded kernels' library, once: Scene*, Lanes*,
    R, the bounce, the stream."""
    lib.crt_shade_bounce.argtypes = [_P, _P, _I, _I, _P]
    lib.crt_shade_bounce.restype = _I
    return lib


def shade_bounce(flat, meta, bounce: int, state, dir, throughput, active, hit_p, hit_tri, hit_inst,
                 hit_u, hit_v):
    """S1: _shade_bounce of the given lanes. Returns its ShadeOut; on CPU
    tensors, _shade_bounce's own."""
    global LAUNCHES
    lanes = (state, dir, throughput, active, hit_p, hit_tri, hit_inst, hit_u, hit_v)
    _check(flat, meta, lanes)
    if state.device.type == "cpu":
        return _shade_bounce(flat, meta, bounce, *lanes)
    R = state.shape[0]
    outs = empty_outputs(R, state.device)
    if R:
        lib = _bind(_build.kernels())
        err = lib.crt_shade_bounce(
            *launch_args(flat, meta, bounce, lanes, outs),
            ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"crt_shade_bounce launch failed: {lib.crt_error_string(err).decode()}")
        LAUNCHES += 1
        tracing.count("lanes.shaded_kernel", R)
    return ShadeOut(*outs)
