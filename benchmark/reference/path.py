"""The plain reference renderer: ChameleonRT's progressive path tracer for a
sample of (pixel, frame, sample) lanes, in plain torch.

It follows chameleonrt_tpu_torch/engine/path_tracer.py as of this
benchmark's first version (render_embree.ispc:105-355): jittered camera
rays, MAX_PATH_DEPTH bounces of closest hit, Disney BSDF shading with
next-event estimation and MIS on quad lights, a continuation sample and
Russian roulette after bounce 3, then the progressive average and the
sRGB8 tonemap. Every lane's RNG stream is the one the program seeds for
its pixel and frame, so the reference computes any pixel of any frame on
its own, and a sample of pixels is compared pixel by pixel. It does not
re-sort the wavefront: no lane's result depends on where it runs.

The scene comes from the benchmark's generators (RefScene), never from
the program: the reference flattens the instances to world triangles,
builds its own LBVH (bvh.py) and packs its own materials and texture atlas.

lowp=True is the lower-precision control: every per-lane float that passes
from one stage to the next (ray directions and origins, hit points, the
BSDF sample, contributions, throughput, illumination, the accumulation)
is stored in bfloat16, the arithmetic within a stage staying float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import bsdf as bsdf_ops
from . import camera as camera_ops
from . import lights as light_ops
from . import rng as rng_ops
from .bsdf import MaterialBatch
from .bvh import T_MAX, PackedBvh, build_packed, traverse_any, traverse_closest
from .lights import LightArrays
from .texture import TextureAtlas, build_quad_rows, textured_color_param, textured_scalar_param
from .vmath import (
    EPSILON,
    MAX_PATH_DEPTH,
    cross,
    dot,
    length,
    linear_to_srgb,
    normalize,
    ortho_basis,
    power_heuristic,
)

_SCALAR_FIELDS = MaterialBatch._fields[1:]


@dataclass
class Light:
    """A quad light (ChameleonRT util/lights.h)."""

    emission: np.ndarray
    position: np.ndarray
    normal: np.ndarray
    v_x: np.ndarray
    v_y: np.ndarray
    width: float
    height: float


@dataclass
class RefScene:
    """What a scene file says, as the benchmark's generator made it: world
    triangles (the instances applied), their uvs and material ids, the
    packed Disney materials (14 floats, texture handles in the bits), the
    textures as RGBA8 with their colour space, and the quad lights."""

    tri_v0: np.ndarray  # (T, 3) float32, world
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_uv: np.ndarray  # (T, 6) float32: uv0, uv1, uv2
    tri_mat: np.ndarray  # (T,) int32
    materials: np.ndarray  # (M, 14) float32
    textures: List[Tuple[np.ndarray, bool]]  # (h, w, 4) uint8, is sRGB
    lights: List[Light]


class Tables(NamedTuple):
    """The reference's device scene."""

    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_uv: torch.Tensor
    tri_mat: torch.Tensor
    mat_rows: torch.Tensor
    lights: LightArrays
    atlas: TextureAtlas
    textured_fields: Tuple[bool, ...]
    bvh: PackedBvh


def build_tables(scene: RefScene, device) -> Tables:
    """Upload the scene and build the reference's own BVH on the device."""

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    v0, e1, e2 = up(scene.tri_v0), up(scene.tri_e1), up(scene.tri_e2)
    if scene.textures:
        table = np.zeros((len(scene.textures), 4), np.int32)
        quads, off = [], 0
        for i, (rgba, srgb) in enumerate(scene.textures):
            h, w = rgba.shape[:2]
            quads.append(build_quad_rows(rgba))
            table[i] = (off, w, h, 1 if srgb else 0)
            off += h * w
        atlas = TextureAtlas(atlas=up(np.concatenate(quads)), table=up(table))
        bits = scene.materials.view(np.uint32) & np.uint32(0x80000000)
        textured = tuple(bool(bits[:, c].any()) for c in (0, *range(3, 14)))
    else:
        atlas = TextureAtlas.empty(device)
        textured = (False,) * 12
    return Tables(
        tri_e1=e1, tri_e2=e2, tri_uv=up(scene.tri_uv), tri_mat=up(scene.tri_mat.astype(np.int64)),
        mat_rows=up(scene.materials), lights=LightArrays.from_scene_lights(scene.lights, device),
        atlas=atlas, textured_fields=textured, bvh=build_packed(v0, e1, e2),
    )


def _material(tables: Tables, mat_id, uv) -> MaterialBatch:
    row = tables.mat_rows[mat_id]
    base_color = row[:, 0:3]
    fields = {name: row[:, 3 + i] for i, name in enumerate(_SCALAR_FIELDS)}
    tf = tables.textured_fields
    atlas = tables.atlas
    return MaterialBatch(
        base_color=textured_color_param(atlas, base_color, uv) if tf[0] else base_color,
        **{k: textured_scalar_param(atlas, v, uv) if tf[1 + i] else v
           for i, (k, v) in enumerate(fields.items())},
    )


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _shade(tables: Tables, bounce: int, state, dir, throughput, active, hit_p, tri, hit_u, hit_v,
           q):
    """One bounce's shading of live lanes (render_embree.ispc:105-181, then
    the continuation sample and Russian roulette). q stores a per-lane
    float between stages (identity, or the bfloat16 round trip)."""
    w_o = -dir
    e1 = tables.tri_e1[tri]
    e2 = tables.tri_e2[tri]
    srow = tables.tri_uv[tri]
    w = hit_u[..., None]
    wv = hit_v[..., None]
    uv = (1.0 - w - wv) * srow[:, 0:2] + w * srow[:, 2:4] + wv * srow[:, 4:6]
    mat = _material(tables, tables.tri_mat[tri], uv)
    normal = normalize(cross(e1, e2))

    flip = (mat.specular_transmission == 0.0) & (dot(w_o, normal) < 0.0)
    n = torch.where(flip[..., None], -normal, normal)
    v_x, v_y = ortho_basis(n)

    state, u_l = rng_ops.lcg_randomf(state)
    R = u_l.shape[0]
    n_lights = tables.lights.width.shape[0]
    if n_lights == 1:
        light = tables.lights.broadcast0(R)
    else:
        light_id = torch.clamp((u_l * n_lights).to(torch.int64), max=n_lights - 1)
        light = tables.lights.gather(light_id)

    state, s2 = rng_ops.lcg_randomf2(state)
    light_pos = light_ops.sample_quad_light_position(light, s2)
    to_light = light_pos - hit_p
    light_dist = length(to_light)
    light_dir = normalize(to_light)
    light_pdf = light_ops.quad_light_pdf(light, light_pos, hit_p, light_dir)
    b_pdf = bsdf_ops.disney_pdf(mat, n, w_o, light_dir, v_x, v_y)

    state, f2, w_i, pdf2 = bsdf_ops.sample_disney_brdf(mat, n, w_o, v_x, v_y, state)
    qhit, t_light, light_pos2 = light_ops.quad_intersect(light, hit_p, w_i)
    light_pdf2 = light_ops.quad_light_pdf(light, light_pos2, hit_p, w_i)
    f2_nonzero = (f2 != 0.0).any(dim=-1)
    shoot2 = active & f2_nonzero & (pdf2 >= EPSILON) & qhit & (light_pdf2 >= EPSILON)
    shoot1 = active & (light_pdf >= EPSILON) & (b_pdf >= EPSILON)

    f1 = bsdf_ops.disney_brdf(mat, n, w_o, light_dir, v_x, v_y)
    w1 = power_heuristic(1.0, light_pdf, 1.0, b_pdf)
    c1 = (f1 * light.emission * dot(light_dir, n).abs()[..., None]
          * (w1 / torch.clamp(light_pdf, min=1e-20))[..., None])
    w2 = power_heuristic(1.0, pdf2, 1.0, light_pdf2)
    c2 = (f2 * light.emission * dot(w_i, n).abs()[..., None]
          * (w2 / torch.clamp(pdf2, min=1e-20))[..., None])

    state, f, w_ic, pdf = bsdf_ops.sample_disney_brdf(mat, n, w_o, v_x, v_y, state)
    cont_ok = (pdf != 0.0) & (f != 0.0).any(dim=-1)
    safe_pdf = torch.where(pdf == 0.0, torch.ones_like(pdf), pdf)
    new_tp = torch.where(active[..., None],
                         throughput * f * (dot(w_ic, n).abs() / safe_pdf)[..., None], throughput)
    new_active = active & cont_ok

    if bounce + 1 > 3:
        state, u_rr = rng_ops.lcg_randomf(state)
        q_rr = torch.clamp(1.0 - new_tp.max(dim=-1).values, min=0.05)
        new_active = new_active & ~(u_rr < q_rr)
        new_tp = torch.where(new_active[..., None],
                             new_tp / torch.clamp(1.0 - q_rr, min=1e-6)[..., None], new_tp)
    return (state, q(c1), q(c2), shoot1, q(light_dir), q(light_dist), shoot2, q(w_i), q(t_light),
            q(new_tp), q(w_ic), new_active)


def trace_lanes(tables: Tables, orig, dir, state, lowp: bool = False):
    """Full paths of the given primary rays. Returns (illumination (R, 3),
    closest-hit rays per lane, shadow rays per lane)."""
    q = _bf16 if lowp else (lambda x: x)
    R, dev = orig.shape[0], orig.device
    orig, dir = q(orig), q(dir)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    illum = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    n_closest = torch.zeros((R,), dtype=torch.int64, device=dev)
    n_any = torch.zeros((R,), dtype=torch.int64, device=dev)
    for bounce in range(MAX_PATH_DEPTH):
        t_min = torch.full((R,), 0.0 if bounce == 0 else EPSILON, dtype=torch.float32, device=dev)
        t, tri, hu, hv = traverse_closest(tables.bvh, orig, dir, t_min, active,
                                          torch.full_like(t_min, T_MAX))
        n_closest += active
        hit = tri >= 0
        missed = active & ~hit
        illum = q(illum + torch.where(missed[..., None], throughput * camera_ops.miss_shader(dir),
                                      torch.zeros_like(illum)))
        active = active & hit
        hit_p = q(orig + t[..., None] * dir)

        live = torch.nonzero(active).flatten()
        sub = _shade(tables, bounce, state[live], dir[live], throughput[live], active[live],
                     hit_p[live], tri[live].long(), hu[live], hv[live], q)
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        z3[:, 2] = 1.0
        z1 = torch.zeros((R,), dtype=torch.float32, device=dev)
        no = torch.zeros((R,), dtype=torch.bool, device=dev)
        dead = (state, torch.zeros_like(z3), torch.zeros_like(z3), no, z3, z1, no, z3, z1,
                throughput, dir, no)
        (state, c1, c2, shoot1, light_dir, light_dist, shoot2, w_i2, t_light, new_tp, cont_dir,
         new_active) = (full.index_put((live,), part) for full, part in zip(dead, sub))

        eps = torch.full((R,), EPSILON, dtype=torch.float32, device=dev)
        occluded1 = traverse_any(tables.bvh, hit_p, light_dir, eps, light_dist, shoot1)
        occluded2 = traverse_any(tables.bvh, hit_p, w_i2, eps, t_light, shoot2)
        n_any += shoot1.long() + shoot2.long()
        zero = torch.zeros_like(illum)
        direct = torch.where((shoot1 & ~occluded1)[..., None], c1, zero) + torch.where(
            (shoot2 & ~occluded2)[..., None], c2, zero)
        illum = q(illum + torch.where(active[..., None], throughput * direct, zero))

        active = new_active
        orig = torch.where(active[..., None], hit_p, orig)
        dir = torch.where(active[..., None], cont_dir, dir)
        throughput = new_tp
    return illum, n_closest, n_any


def render_pixels(tables: Tables, view: camera_ops.ViewParams, pixel_x, pixel_y, frames: int,
                  fb_width: int, fb_height: int, spp: int, lowp: bool = False,
                  max_lanes: int = 1 << 20):
    """The progressive accumulation of the given pixels (int64 tensors) over
    frames 0 .. frames-1, as the program's buffer holds it after them.
    Lanes (pixel, frame, sample) are traced in batches of at most
    max_lanes. Returns (accumulation (P, 3), closest-hit rays and shadow
    rays over all the lanes, as ints)."""
    dev = pixel_x.device
    P = pixel_x.shape[0]
    pixel_id = (pixel_x + pixel_y * fb_width) & rng_ops.MASK32
    # lane order: frame-major, then sample, then pixel
    F, S = frames, spp
    lane_f = torch.arange(F, device=dev).repeat_interleave(S * P)
    lane_s = torch.arange(S, device=dev).repeat_interleave(P).repeat(F)
    lane_p = torch.arange(P, device=dev).repeat(F * S)
    illum = torch.empty((F * S * P, 3), dtype=torch.float32, device=dev)
    n_closest = n_any = 0
    for lo in range(0, F * S * P, max_lanes):
        sl = slice(lo, min(lo + max_lanes, F * S * P))
        p = lane_p[sl]
        state = rng_ops.get_rng(pixel_id[p], (lane_f[sl] * S + 1 + lane_s[sl]) & rng_ops.MASK32)
        state, orig, dir = camera_ops.generate_primary_rays(
            view, pixel_x[p], pixel_y[p], float(fb_width), float(fb_height), state)
        il, nc, na = trace_lanes(tables, orig, dir, state, lowp)
        illum[sl] = il
        n_closest += int(nc.sum())
        n_any += int(na.sum())
    q = _bf16 if lowp else (lambda x: x)
    illum = illum.reshape(F, S, P, 3)
    accum = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    for f in range(F):
        sums = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        for s in range(S):
            sums = sums + illum[f, s]
        fid = float(f)
        accum = q((sums / float(S) + fid * accum) / (fid + 1.0))
    return accum, n_closest, n_any


def frame_rays(tables: Tables, view: camera_ops.ViewParams, frame: int, fb_width: int,
               fb_height: int, spp: int, lowp: bool = False, max_lanes: int = 1 << 20) -> int:
    """The rays one whole frame traces: the closest-hit and shadow rays of
    every (pixel, sample) lane of frame `frame`, lanes traced in batches of
    at most max_lanes."""
    dev = tables.tri_e1.device
    n_pixels = fb_width * fb_height
    total = 0
    for lo in range(0, spp * n_pixels, max_lanes):
        lane = torch.arange(lo, min(lo + max_lanes, spp * n_pixels), device=dev)
        s, p = lane // n_pixels, lane % n_pixels
        px, py = p % fb_width, p // fb_width
        state = rng_ops.get_rng(p & rng_ops.MASK32, (frame * spp + 1 + s) & rng_ops.MASK32)
        state, orig, dir = camera_ops.generate_primary_rays(
            view, px, py, float(fb_width), float(fb_height), state)
        _, nc, na = trace_lanes(tables, orig, dir, state, lowp)
        total += int(nc.sum()) + int(na.sum())
    return total


def tonemap_u8(accum):
    """Linear accumulation -> sRGB8 (render_embree.ispc:358-370)."""
    srgb = torch.clamp(linear_to_srgb(accum), 0.0, 1.0)
    return (srgb * 255.0 + 0.5).to(torch.uint8)
