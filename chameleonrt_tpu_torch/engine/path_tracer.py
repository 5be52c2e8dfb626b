"""The wavefront path tracer (torch): the counterpart of
chameleonrt_tpu/engine/path_tracer.py.

Jittered camera rays, then MAX_PATH_DEPTH bounces of: a stable re-sort of
the whole wavefront by ray coherence (R1-R3 and an int32 sort on the card,
ops/sort_cuda.py), one closest-hit traversal, shading of
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
revives, so skipping its draws cannot change the image. On the card the
live lanes' shading is one launch of S1 (ops/shade_cuda.py); on the CPU it
is _shade_bounce, S1's plain version.

A frame may be split into shards (render_shards; parallel/sharded.py), each
traced on its own device with that device's tables, bounce by bounce
together. With rebalance, shards swap rows of their wavefronts between
bounces (_exchange_wavefront). Per-lane math does not depend on where a
lane runs, so the image is the single-device image.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from chameleonrt_tpu_torch.core import tracing
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
from chameleonrt_tpu_torch.ops import shade_cuda, sort_cuda
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
    continuation sample and Russian roulette). Pure per-lane math: the
    plain version of S1 (ops/shade_cuda.py, csrc/shade.cu), which runs it
    on CUDA lanes; this runs on CPU lanes."""
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


def _count_lobes(flat: FlatScene, meta: SceneMeta, tri, inst) -> None:
    """Count, on the device, the live lanes (hits: tri and inst valid) whose
    hit material has metallic > 0 (lanes.metallic) and specular
    transmission > 0 (lanes.transmissive); a textured field (a handle,
    negative as a float) counts as 0. Only with tracing on: the counts come
    back with the frame's ray count."""
    tri = tri.long()
    if meta.num_instances == 1:
        # the packed material rides in the shade row, from column 16
        metallic, transmission = flat.shade_rows[tri, 19], flat.shade_rows[tri, 29]
    else:
        slot = flat.shade_rows[:, 12].view(torch.int32)[tri]
        mat = flat.inst_mat_table[inst.long(), slot.long()].long()
        metallic, transmission = flat.mat_rows[mat, 3], flat.mat_rows[mat, 13]
    tracing.count_on_device("lanes.metallic", (metallic > 0.0).sum())
    tracing.count_on_device("lanes.transmissive", (transmission > 0.0).sum())


def _shade_live(flat, meta, bounce, state, orig, dir, throughput, active, hit_p, hit: Hit) -> ShadeOut:
    """_shade_bounce over the live lanes only (S1 on CUDA lanes,
    ops/shade_cuda.py), scattered back into full-width results. A dead
    lane keeps its state, throughput and direction and shoots no shadow
    ray."""
    R = orig.shape[0]
    with tracing.sync("compact.nonzero"):
        live = torch.nonzero(active).flatten()
    tracing.count("lanes.shaded", live.shape[0])
    if tracing.enabled():
        with tracing.span("bounce.lobes"):
            _count_lobes(flat, meta, hit.tri[live], hit.inst[live])
    lanes = (state[live], orig[live], dir[live], throughput[live], active[live], hit_p[live],
             hit.tri[live], hit.inst[live], hit.u[live], hit.v[live])
    with tracing.span("bounce.shade"):
        sub = shade_cuda.shade_bounce(flat, meta, bounce, *lanes)
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
    to every field. On CUDA fields R1-R3 around an int32 sort
    (ops/sort_cuda.py), on the fields' own device; on CPU fields the plain
    argsort and gathers."""
    return sort_cuda.sort_wavefront(state, orig, dir, throughput, illum, active, lane_pixel)


def _on(device: torch.device):
    """Make a CUDA device current (the kernels' C entries launch on the
    current device); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Shard(NamedTuple):
    """One shard of a frame: the scene tables and trace functions of its
    device, its pixels, and, in a sharded frame, each lane's id in the
    padded frame (scatter_ids; rebalanced frames) and whether its pixel
    lies in the frame (active0; a padding row's lanes are born dead)."""

    flat: FlatScene
    trace_closest: TraceClosestFn
    trace_any: TraceAnyFn
    pixel_x: torch.Tensor
    pixel_y: torch.Tensor
    scatter_ids: Optional[torch.Tensor] = None
    active0: Optional[torch.Tensor] = None


def _start_wavefront(orig, dir, state, lane_ids=None, active0=None):
    """The path state of fresh primary rays, in _sort_wavefront's field
    order: (state, orig, dir, throughput, illum, active, lane_pixel)."""
    R = orig.shape[0]
    dev = orig.device
    active = torch.ones((R,), dtype=torch.bool, device=dev) if active0 is None else active0
    lane_pixel = torch.arange(R, dtype=torch.int64, device=dev) if lane_ids is None else lane_ids
    return (state, orig, dir, torch.ones((R, 3), dtype=torch.float32, device=dev),
            torch.zeros((R, 3), dtype=torch.float32, device=dev), active, lane_pixel)


def _bounce(flat: FlatScene, meta: SceneMeta, trace_closest: TraceClosestFn,
            trace_any: TraceAnyFn, bounce: int, wave):
    """One bounce of a sorted wavefront: closest hit, shading of the live
    lanes, the two occlusion traversals. Returns (the wavefront after it,
    rays traced as a 0-dim int64 tensor)."""
    state, orig, dir, throughput, illum, active, lane_pixel = wave
    with tracing.span("bounce.closest", bounce):
        hit = trace_closest(flat, orig, dir, 0.0 if bounce == 0 else EPSILON, active)
    with tracing.span("bounce.combine", bounce):
        closest_rays = active.sum()
        missed = active & ~hit.hit
        illum = illum + torch.where(
            missed[..., None], throughput * camera_ops.miss_shader(dir), torch.zeros_like(illum)
        )
        active = active & hit.hit
        hit_p = orig + hit.t[..., None] * dir

    with tracing.span("bounce.compact", bounce):
        sh = _shade_live(flat, meta, bounce, state, orig, dir, throughput, active, hit_p, hit)
    state = sh.state

    with tracing.span("bounce.any", bounce):
        occluded1 = trace_any(flat, hit_p, sh.light_dir, sh.light_dist, sh.shoot1)
        occluded2 = trace_any(flat, hit_p, sh.w_i2, sh.t_light, sh.shoot2)
    with tracing.span("bounce.combine", bounce):
        any_rays = sh.shoot1.sum() + sh.shoot2.sum()
        rays = closest_rays + any_rays
        tracing.count_on_device("rays.closest", closest_rays)
        tracing.count_on_device("rays.any", any_rays)
        zero = torch.zeros_like(illum)
        direct = torch.where((sh.shoot1 & ~occluded1)[..., None], sh.c1, zero) + torch.where(
            (sh.shoot2 & ~occluded2)[..., None], sh.c2, zero
        )
        illum = illum + torch.where(active[..., None], throughput * direct, zero)

        active = sh.new_active
        orig = torch.where(active[..., None], hit_p, orig)
        dir = torch.where(active[..., None], sh.cont_dir, dir)
    return (state, orig, dir, sh.new_throughput, illum, active, lane_pixel), rays


def _hypercube_perm(n_dev: int, bit: int):
    """(shard, partner) pairs of an exchange along hypercube dimension
    `bit`; a shard whose partner falls outside the mesh pairs with itself."""
    return [(d, d ^ bit if d ^ bit < n_dev else d) for d in range(n_dev)]


def _exchange_wavefront(waves, bit: int):
    """Active-ray rebalancing between shards, the counterpart of the JAX
    package's ppermute exchange: every shard swaps one slice of S whole
    rows of its sorted wavefront (actives first) with its hypercube
    partner along `bit`. The busier side sends its last ~surplus/2 active
    rows, the other side rows from its dead tail; a row carries its lane's
    RNG state, throughput, illumination and lane id, so a migrated ray
    finishes its path on its new shard. The swap is simultaneous: every
    slice and active count is read before any shard is written. Returns
    (the wavefronts, active lanes that changed shard)."""
    R = waves[0][1].shape[0]
    S = max(min(R // 8, 16384), 8)
    if R < S:
        raise ValueError(f"a shard of {R} lanes cannot swap a slice of {S} rows")
    n_act = []
    for w in waves:
        with tracing.sync("exchange.counts"):
            n_act.append(int(w[5].sum()))
    perm = _hypercube_perm(len(waves), bit)
    starts = []
    for d, p in perm:
        surplus = max((n_act[d] - n_act[p]) // 2, 0)
        starts.append(min(max(n_act[d] - min(surplus, S), 0), R - S))
    out, moved = [], 0
    for d, p in perm:
        if p == d:
            out.append(waves[d])
            continue
        sent = starts[p]
        fields = []
        for mine, theirs in zip(waves[d], waves[p]):
            new = mine.clone()
            new[starts[d]:starts[d] + S] = theirs[sent:sent + S].to(mine.device)
            fields.append(new)
        out.append(tuple(fields))
        moved += min(max(n_act[p] - sent, 0), S)
    return out, moved


def _trace_waves(meta: SceneMeta, shards, waves, rebalance: bool = False):
    """Full paths of every shard's wavefront, bounce by bounce across the
    shards: each bounce re-sorts every wavefront, then (rebalance, from
    bounce 1 on) exchanges rows between shards along a hypercube dimension
    that rotates with the bounce, then traces and shades every shard on
    its device. Returns (wavefronts, rays per shard, lanes moved)."""
    n = len(shards)
    dims = max(1, (n - 1).bit_length())
    rays = [0] * n
    moved = 0
    for bounce in range(MAX_PATH_DEPTH):
        with tracing.span("bounce.sort", bounce):
            waves = [_sort_wavefront(*w) for w in waves]
        if rebalance and n > 1 and bounce >= 1:
            with tracing.span("bounce.exchange", bounce):
                waves, m = _exchange_wavefront(waves, 1 << ((bounce - 1) % dims))
            moved += m
        for i, (sh, wave) in enumerate(zip(shards, waves)):
            with _on(wave[1].device):
                waves[i], r = _bounce(sh.flat, meta, sh.trace_closest, sh.trace_any, bounce, wave)
            with tracing.span("bounce.combine", bounce):
                rays[i] = rays[i] + r
    return waves, rays, moved


def trace_path(flat: FlatScene, meta: SceneMeta, trace_closest: TraceClosestFn,
               trace_any: TraceAnyFn, orig, dir, state):
    """One full path per lane from the given primary rays. Returns
    (state, illum (R, 3), lane_pixel, rays traced as a 0-dim int64 tensor).
    illum is in the re-sorted lane order: lane_pixel maps each lane to its
    index in the input ray order."""
    shard = Shard(flat, trace_closest, trace_any, None, None)
    (wave,), (rays,), _ = _trace_waves(meta, [shard], [_start_wavefront(orig, dir, state)])
    state, _, _, _, illum, _, lane_pixel = wave
    return state, illum, lane_pixel, rays


def render_shards(meta: SceneMeta, shards, view: camera_ops.ViewParams, frame_id: int,
                  fb_width: int, fb_height: int, spp: int, scatter_rows: int = 0,
                  rebalance: bool = False):
    """Illumination of one progressive frame over shards (Shard) traced
    bounce by bounce together (_trace_waves). A shard's illumination is
    (R, 3) in its input order, or, where its scatter_ids are set, a
    (scatter_rows, 3) partial frame indexed by them. Returns (illumination
    averaged over spp, per shard; rays traced per shard as 0-dim int64
    tensors; active lanes moved between shards)."""
    with tracing.span("frame.camera"):
        pixel_ids = [(s.pixel_x + s.pixel_y * fb_width) & rng_ops.MASK32 for s in shards]
        sums = [torch.zeros((scatter_rows if s.scatter_ids is not None else p.shape[0], 3),
                            dtype=torch.float32, device=p.device) for s, p in zip(shards, pixel_ids)]
        rays = [torch.zeros((), dtype=torch.int64, device=p.device) for p in pixel_ids]
    moved = 0
    for s in range(spp):
        with tracing.span("frame.sample"):
            waves = []
            with tracing.span("frame.camera"):
                for sh, pixel_id in zip(shards, pixel_ids):
                    # embree-variant seeding (ispc:213-214)
                    state = rng_ops.get_rng(pixel_id, (frame_id * spp + 1 + s) & rng_ops.MASK32)
                    state, orig, dir = camera_ops.generate_primary_rays(
                        view, sh.pixel_x, sh.pixel_y, float(fb_width), float(fb_height), state
                    )
                    waves.append(_start_wavefront(orig, dir, state, sh.scatter_ids, sh.active0))
            waves, rays_s, moved_s = _trace_waves(meta, shards, waves, rebalance)
        moved += moved_s
        with tracing.span("frame.accumulate"):
            for i, wave in enumerate(waves):
                _, _, _, _, illum, _, lane_pixel = wave
                # a sample whose radiance left float32 (a throughput grown past its range at
                # grazing angles on near-specular glass, then inf, or inf * 0) is dropped, so
                # that it cannot poison its pixel's progressive average for good
                illum = torch.where(torch.isfinite(illum).all(-1, keepdim=True), illum, 0.0)
                # one scatter restores input order (or places the lanes in the frame)
                sums[i] = sums[i] + torch.zeros_like(sums[i]).index_put((lane_pixel,), illum)
                rays[i] = rays[i] + rays_s[i]
    with tracing.span("frame.accumulate"):
        return [x / float(spp) for x in sums], rays, moved


def render_pixels(flat: FlatScene, meta: SceneMeta, trace_closest: TraceClosestFn,
                  trace_any: TraceAnyFn, view: camera_ops.ViewParams, frame_id: int,
                  pixel_x, pixel_y, fb_width: int, fb_height: int, spp: int,
                  scatter_ids=None, scatter_rows: int = 0, active0=None):
    """Illumination of one progressive frame for the given pixels (int64
    tensors). Returns (illum averaged over spp, rays traced as a 0-dim
    int64 tensor). illum is (R, 3) in input order; with scatter_ids, a
    (scatter_rows, 3) frame with each lane's result at its id. active0
    starts the lanes it marks False dead: they trace and count nothing."""
    shard = Shard(flat, trace_closest, trace_any, pixel_x, pixel_y, scatter_ids, active0)
    (illum,), (rays,), _ = render_shards(meta, [shard], view, frame_id, fb_width, fb_height,
                                         spp, scatter_rows)
    return illum, rays


def progressive_accum(accum, illum, frame_id: int):
    """Running average (ispc:345-353): (illum + n * accum) / (n + 1)."""
    fid = float(frame_id)
    with tracing.span("frame.accumulate"):
        return (illum + fid * accum) / (fid + 1.0)
