"""The wavefront path tracer (torch): the counterpart of
chameleonrt_tpu/engine/path_tracer.py.

Jittered camera rays, then MAX_PATH_DEPTH bounces of: a stable re-sort of
the whole wavefront by ray coherence, one closest-hit traversal, shading of
the live lanes (Disney BSDF, next-event estimation with MIS on quad lights,
continuation sample, Russian roulette after bounce 3), and two occlusion
traversals, one per MIS branch; then the progressive average.

Traversal comes in as a pair of functions (engine/trace_bvh.py), so the
shading and RNG code is the same whichever traversal runs. RNG draws per
lane follow the reference's order (render_embree.ispc:198-355): jitter x,
y; then per bounce light pick, light u, v, the bsdf-branch sample
(component, u1, u2), the continuation sample (component, u1, u2) and the
roulette draw after bounce 3.

Shading runs only on live lanes (index compaction); a dead lane never
revives, so skipping its draws cannot change the image.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from chameleonrt_tpu_torch.engine.device_scene import (
    FlatScene,
    SceneMeta,
    unpack_material,
    unpack_material_row,
)
from chameleonrt_tpu_torch.ops import bsdf as bsdf_ops
from chameleonrt_tpu_torch.ops import camera as camera_ops
from chameleonrt_tpu_torch.ops import lights as light_ops
from chameleonrt_tpu_torch.ops import rng as rng_ops
from chameleonrt_tpu_torch.ops.intersect import Hit
from chameleonrt_tpu_torch.ops.math import (
    EPSILON,
    MAX_PATH_DEPTH,
    cross,
    dot,
    length,
    normalize,
    ortho_basis,
    power_heuristic,
)
from chameleonrt_tpu_torch.ops.traverse import ray_sort_perm_only

# trace_closest(flat, orig, dir, t_min, active) -> Hit
TraceClosestFn = Callable[..., Hit]
# trace_any(flat, orig, dir, t_max, mask) -> occluded (R,) bool; t_min = EPSILON
TraceAnyFn = Callable[..., torch.Tensor]


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
    flat: FlatScene, meta: SceneMeta, bounce: int, state, orig, dir, throughput,
    active, hit_p, hit_tri, hit_inst, hit_u, hit_v,
) -> ShadeOut:
    """The shading stage of one bounce for a set of lanes
    (render_embree.ispc:105-181 without the occlusion calls, then the
    continuation sample and Russian roulette). Pure per-lane math."""
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


def _shade_live(flat, meta, bounce, state, orig, dir, throughput, active, hit_p, hit: Hit) -> ShadeOut:
    """_shade_bounce over the live lanes only, scattered back into
    full-width results. A dead lane keeps its state, throughput and
    direction and shoots no shadow ray."""
    R = orig.shape[0]
    live = torch.nonzero(active).flatten()
    sub = _shade_bounce(
        flat, meta, bounce, state[live], orig[live], dir[live], throughput[live],
        active[live], hit_p[live], hit.tri[live], hit.inst[live], hit.u[live], hit.v[live],
    )
    z3 = torch.zeros((R, 3), dtype=torch.float32, device=orig.device)
    z3[:, 2] = 1.0
    z1 = torch.zeros((R,), dtype=torch.float32, device=orig.device)
    no = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    dead = ShadeOut(
        state=state, c1=torch.zeros_like(z3), c2=torch.zeros_like(z3), shoot1=no,
        light_dir=z3, light_dist=z1, shoot2=no, w_i2=z3, t_light=z1,
        new_throughput=throughput, cont_dir=dir, new_active=no,
    )
    return ShadeOut(*(full.index_put((live,), part) for full, part in zip(dead, sub)))


def _sort_wavefront(state, orig, dir, throughput, illum, active, lane_pixel):
    """Re-sort the whole path state by (active, coarse origin Morton,
    direction octant, fine origin Morton): one stable permutation applied
    to every field."""
    perm = ray_sort_perm_only(orig, dir, active)
    return tuple(x[perm] for x in (state, orig, dir, throughput, illum, active, lane_pixel))


def trace_path(flat: FlatScene, meta: SceneMeta, trace_closest: TraceClosestFn,
               trace_any: TraceAnyFn, orig, dir, state):
    """One full path per lane from the given primary rays. Returns
    (state, illum (R, 3), lane_pixel, rays traced as a 0-dim int64 tensor).
    illum is in the re-sorted lane order: lane_pixel maps each lane to its
    index in the input ray order."""
    R = orig.shape[0]
    dev = orig.device
    illum = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    lane_pixel = torch.arange(R, dtype=torch.int64, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    t_min = 0.0

    for bounce in range(MAX_PATH_DEPTH):
        state, orig, dir, throughput, illum, active, lane_pixel = _sort_wavefront(
            state, orig, dir, throughput, illum, active, lane_pixel
        )
        hit = trace_closest(flat, orig, dir, t_min, active)
        rays = rays + active.sum()

        missed = active & ~hit.hit
        illum = illum + torch.where(
            missed[..., None], throughput * camera_ops.miss_shader(dir), torch.zeros_like(illum)
        )
        active = active & hit.hit
        hit_p = orig + hit.t[..., None] * dir

        sh = _shade_live(flat, meta, bounce, state, orig, dir, throughput, active, hit_p, hit)
        state = sh.state

        occluded1 = trace_any(flat, hit_p, sh.light_dir, sh.light_dist, sh.shoot1)
        occluded2 = trace_any(flat, hit_p, sh.w_i2, sh.t_light, sh.shoot2)
        rays = rays + sh.shoot1.sum() + sh.shoot2.sum()
        zero = torch.zeros_like(illum)
        direct = torch.where((sh.shoot1 & ~occluded1)[..., None], sh.c1, zero) + torch.where(
            (sh.shoot2 & ~occluded2)[..., None], sh.c2, zero
        )
        illum = illum + torch.where(active[..., None], throughput * direct, zero)

        throughput = sh.new_throughput
        active = sh.new_active
        orig = torch.where(active[..., None], hit_p, orig)
        dir = torch.where(active[..., None], sh.cont_dir, dir)
        t_min = EPSILON
    return state, illum, lane_pixel, rays


def render_pixels(flat: FlatScene, meta: SceneMeta, trace_closest: TraceClosestFn,
                  trace_any: TraceAnyFn, view: camera_ops.ViewParams, frame_id: int,
                  pixel_x, pixel_y, fb_width: int, fb_height: int, spp: int):
    """Illumination of one progressive frame for the given pixels (int64
    tensors). Returns (illum (R, 3) averaged over spp, in input order; rays
    traced as a 0-dim int64 tensor)."""
    pixel_id = (pixel_x + pixel_y * fb_width) & rng_ops.MASK32
    R = pixel_id.shape[0]
    illum_sum = torch.zeros((R, 3), dtype=torch.float32, device=pixel_id.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixel_id.device)
    for s in range(spp):
        # embree-variant seeding (ispc:213-214)
        state = rng_ops.get_rng(pixel_id, (frame_id * spp + 1 + s) & rng_ops.MASK32)
        state, orig, dir = camera_ops.generate_primary_rays(
            view, pixel_x, pixel_y, float(fb_width), float(fb_height), state
        )
        _, illum, lane_pixel, rays_s = trace_path(
            flat, meta, trace_closest, trace_any, orig, dir, state
        )
        # one scatter restores input-ray order
        illum_sum = illum_sum + torch.zeros_like(illum).index_put((lane_pixel,), illum)
        rays = rays + rays_s
    return illum_sum / float(spp), rays


def progressive_accum(accum, illum, frame_id: int):
    """Running average (ispc:345-353): (illum + n * accum) / (n + 1)."""
    fid = float(frame_id)
    return (illum + fid * accum) / (fid + 1.0)
