"""Plain BVH traversal in torch: the counterpart of the XLA lockstep traversal
in chameleonrt_tpu/ops/traverse.py (traverse_closest / traverse_any, the
two-level traverse_closest_unified / traverse_any_unified, and
ray_sort_perm_only).

This is the plain version of kernels B1-B6d (ops/traverse_cuda.py): the
CPU path, and the version the kernels are held against on the card. Each
lane follows the same depth-first order as the XLA oracle: at an internal
row it tests every child, pushes the hit children far-first in
``_SORT_NETS`` order and descends into the nearest; at a leaf it runs
Möller–Trumbore on all L slots and then pops. In a two-level table an
instance-entry leaf instead moves the lane into that instance's object
space and jumps to its BLAS root. The lanes advance in lockstep, and lanes
that finish are dropped from the working set after each step, so a step
costs the live lanes only.
"""

from __future__ import annotations

import torch

from chameleonrt_tpu_torch.engine.device_scene import PackedBvh, UnifiedBvh
from chameleonrt_tpu_torch.ops.intersect import _MT_EPS, ONE_PLUS_UV_EPS, T_MAX, UV_EPS

STACK_DEPTH = 48
_DONE = 0x7FFFFFFF  # current-node sentinel: lane finished
_BIG = 1e30  # sort key of a child whose box the ray misses

# ascending sorting networks (Bose–Nelson n=4, Batcher odd-even merge n=8)
_SORT_NETS = {
    2: ((0, 1),),
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: (
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6),
    ),
}


class WalkCount:
    """What one plain walk did, for a kernel's least time on the same rays
    (chip_smoke.py's bound): the distinct node, triangle-leaf and
    instance-entry rows the rays visited, how many visits of each kind the
    lanes made, and the tests those visits need: one slab test per live
    child of a visited node row (an empty slot, lo = hi = 1e30, needs
    none), one Möller–Trumbore per valid slot of a visited triangle leaf
    (prim >= 0; padding needs none). An entry visit transforms the ray.
    Only a caller that asks for it passes one; the render path never
    does."""

    def __init__(self, table):
        dev = table.nodes.device
        arity = table.nodes.shape[1] // 8
        L = table.leaf_rows.shape[1] // 10
        self.node_seen = torch.zeros(table.nodes.shape[0], dtype=torch.bool, device=dev)
        self.leaf_seen = torch.zeros(table.leaf_rows.shape[0], dtype=torch.bool, device=dev)
        self.n_tri = getattr(table, "n_tri_leaves", table.leaf_rows.shape[0])
        self.live_children = (table.nodes[:, 0 : 6 * arity : 6] < _BIG).sum(dim=1)
        self.live_slots = (table.leaf_rows.view(torch.int32)[:, 9 * L : 10 * L] >= 0).sum(dim=1)
        # node, leaf and entry visits; slab tests; Möller–Trumbore slots
        self.visits = torch.zeros(5, dtype=torch.int64, device=dev)

    def step(self, cur):
        """Record one lockstep step of the live lanes at rows cur."""
        node = cur >= 0
        leaf = torch.where(node, 0, -cur - 1).long()
        tri = ~node & (leaf < self.n_tri)
        self.node_seen[cur[node].long()] = True
        self.leaf_seen[leaf[~node]] = True
        self.visits += torch.stack([
            node.sum(), tri.sum(), (~node & ~tri).sum(),
            self.live_children[cur[node].long()].sum(), self.live_slots[leaf[tri]].sum(),
        ])

    def totals(self) -> dict:
        node_visits, leaf_visits, entry_visits, slab_tests, mt_slots = (int(x) for x in self.visits)
        leaves = self.leaf_seen.nonzero().flatten()
        return {
            "node_rows": int(self.node_seen.sum()),
            "leaf_rows": int((leaves < self.n_tri).sum()),
            "entry_rows": int((leaves >= self.n_tri).sum()),
            "node_visits": node_visits, "leaf_visits": leaf_visits, "entry_visits": entry_visits,
            "slab_tests": slab_tests, "mt_slots": mt_slots,
        }


def stack_limit(pbvh: PackedBvh) -> int:
    """Short-stack size: one slot per certified level, capped at
    STACK_DEPTH. Pushing onto a full stack is an overflow."""
    return max(2, min(STACK_DEPTH, int(pbvh.max_depth) + 1))


def _slab(row, c, orig, inv_dir, t_min, t_max):
    """Ray vs the child box at cols [c, c+6) of each row. A NaN from
    0 * inf counts as an unbounded slab, as in the XLA oracle."""
    inf = float("inf")
    near, far = [], []
    for a in range(3):
        t0 = (row[:, c + a] - orig[:, a]) * inv_dir[:, a]
        t1 = (row[:, c + 3 + a] - orig[:, a]) * inv_dir[:, a]
        n = torch.minimum(t0, t1)
        f = torch.maximum(t0, t1)
        near.append(torch.where(torch.isnan(n), -inf, n))
        far.append(torch.where(torch.isnan(f), inf, f))
    entry = torch.maximum(torch.maximum(near[0], near[1]), torch.maximum(near[2], t_min))
    exit_ = torch.minimum(torch.minimum(far[0], far[1]), torch.minimum(far[2], t_max))
    return entry <= exit_, entry


def _node_phase(pbvh: PackedBvh, cur, is_int, orig, inv_dir, t_min, t_max):
    """Internal step: one row gather, every child's slab test, and a sorting
    network over the hit children by entry distance. Returns (next_int,
    pushes): the nearest hit child (or _DONE) and (code, mask) pairs in
    push order, farthest first."""
    arity = pbvh.arity
    row = pbvh.nodes[torch.clamp(cur, 0, pbvh.nodes.shape[0] - 1).long()]
    row_i = row.view(torch.int32)
    keys, codes = [], []
    for c in range(arity):
        hit_c, entry_c = _slab(row, 6 * c, orig, inv_dir, t_min, t_max)
        keys.append(torch.where(hit_c & is_int, entry_c, torch.full_like(entry_c, _BIG)))
        codes.append(row_i[:, 6 * arity + c])
    for i, j in _SORT_NETS[arity]:
        swap = keys[i] > keys[j]
        keys[i], keys[j] = torch.where(swap, keys[j], keys[i]), torch.where(swap, keys[i], keys[j])
        codes[i], codes[j] = (
            torch.where(swap, codes[j], codes[i]),
            torch.where(swap, codes[i], codes[j]),
        )
    next_int = torch.where(keys[0] < _BIG, codes[0], torch.full_like(codes[0], _DONE))
    pushes = [(codes[k], keys[k] < _BIG) for k in range(arity - 1, 0, -1)]
    return next_int, pushes


def _mt_rows(rows, L, orig, dir, t_min, t_max):
    """Möller–Trumbore over gathered component-major leaf rows (n, 10L).
    Returns (hit, t, u, v, prim), each (n, L)."""

    def g(c):
        return rows[:, c * L : (c + 1) * L]

    v0x, v0y, v0z = g(0), g(1), g(2)
    e1x, e1y, e1z = g(3), g(4), g(5)
    e2x, e2y, e2z = g(6), g(7), g(8)
    prim = rows.view(torch.int32)[:, 9 * L : 10 * L]
    ox, oy, oz = orig[:, 0:1], orig[:, 1:2], orig[:, 2:3]
    dx, dy, dz = dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    small = det.abs() < _MT_EPS
    inv = 1.0 / torch.where(small, torch.ones_like(det), det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (
        ~small
        & (prim >= 0)
        & (u >= -UV_EPS)
        & (v >= -UV_EPS)
        & (u + v <= ONE_PLUS_UV_EPS)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return hit, t, u, v, prim


def _leaf_closest(rows, L, orig, dir, t_min, t_max):
    """Closest slot of one gathered leaf row per lane; ties go to the
    highest slot. Returns (t, prim, u, v) with t = T_MAX, prim = -1 on a
    miss."""
    hit, t, u, v, prim = _mt_rows(rows, L, orig, dir, t_min, t_max)
    t = torch.where(hit, t, torch.full_like(t, T_MAX))
    best_t = t.min(dim=1).values
    iota = torch.arange(L, dtype=torch.int32, device=t.device)[None, :]
    is_best = hit & (t == best_t[:, None])
    slot = torch.where(is_best, iota, torch.full_like(prim, -1)).max(dim=1).values
    sel = iota == slot[:, None]
    best_prim = torch.where(sel, prim, torch.full_like(prim, -1)).max(dim=1).values
    best_u = torch.where(sel, u, torch.zeros_like(u)).sum(dim=1)
    best_v = torch.where(sel, v, torch.zeros_like(v)).sum(dim=1)
    return best_t, best_prim, best_u, best_v


def _push(stack, sp, limit, code, push):
    """Push code where push; returns (sp, overflow mask). A push onto a full
    stack overwrites the top slot and reports overflow."""
    ovf = push & (sp >= limit - 1)
    slot = sp[:, None].long()
    old = stack.gather(1, slot)[:, 0]
    stack.scatter_(1, slot, torch.where(push, code, old)[:, None])
    sp = torch.where(push, torch.clamp(sp + 1, max=limit - 1), sp)
    return sp, ovf


def _start_lanes(pbvh: PackedBvh, lanes):
    """Initial (cur, stack, sp) for n live lanes: the root row, or leaf 0
    when the table is a single leaf."""
    n = lanes.shape[0]
    dev = lanes.device
    root = -1 if pbvh.num_leaves == 1 else 0
    limit = stack_limit(pbvh)
    cur = torch.full((n,), root, dtype=torch.int32, device=dev)
    stack = torch.full((n, limit), _DONE, dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int32, device=dev)
    return cur, stack, sp, limit


def traverse_closest(pbvh: PackedBvh, orig, dir, t_min, active, t_max=None, count=None):
    """Closest hit per lane. orig, dir (R, 3) f32; t_min, t_max (R,) f32;
    active (R,) bool. Returns (t, prim, u, v): a miss or inactive lane is
    (T_MAX, -1, 0, 0); a stack overflow is prim = -2, t = T_MAX. count, a
    WalkCount, records the walk's work."""
    R = orig.shape[0]
    dev = orig.device
    t_out = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    prim_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    best0 = t_out if t_max is None else torch.minimum(t_out, t_max)

    lanes = torch.nonzero(active).flatten()
    o, d, tmn = orig[lanes], dir[lanes], t_min[lanes]
    inv = 1.0 / d
    bt = best0[lanes]
    bp = torch.full_like(lanes, -1, dtype=torch.int32)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    ovf = torch.zeros_like(lanes, dtype=torch.bool)
    cur, stack, sp, limit = _start_lanes(pbvh, lanes)

    while lanes.numel():
        if count is not None:
            count.step(cur)
        is_leaf = cur < 0
        is_int = ~is_leaf
        next_int, pushes = _node_phase(pbvh, cur, is_int, o, inv, tmn, bt)
        for code, push in pushes:
            sp, o_flow = _push(stack, sp, limit, code, push)
            ovf |= o_flow

        leaf_id = torch.where(is_leaf, -cur - 1, torch.zeros_like(cur))
        rows = pbvh.leaf_rows[leaf_id.long()]
        lt, lp, lu, lv = _leaf_closest(rows, pbvh.leaf_size, o, d, tmn, bt)
        take = is_leaf & (lt < bt)
        bt = torch.where(take, lt, bt)
        bp = torch.where(take, lp, bp)
        bu = torch.where(take, lu, bu)
        bv = torch.where(take, lv, bv)

        descend = is_int & (next_int != _DONE)
        can_pop = ~descend & (sp > 0)
        sp = torch.where(can_pop, sp - 1, sp)
        popped = stack.gather(1, sp[:, None].long())[:, 0]
        cur = torch.where(descend, next_int, torch.where(can_pop, popped, torch.full_like(cur, _DONE)))

        done = cur == _DONE
        if bool(done.any()):
            idx = lanes[done]
            p = torch.where(ovf[done], torch.full_like(bp[done], -2), bp[done])
            t_out[idx] = torch.where(p < 0, torch.full_like(bt[done], T_MAX), bt[done])
            prim_out[idx] = p
            u_out[idx] = bu[done]
            v_out[idx] = bv[done]
            keep = ~done
            lanes, o, d, inv, tmn = lanes[keep], o[keep], d[keep], inv[keep], tmn[keep]
            bt, bp, bu, bv, ovf = bt[keep], bp[keep], bu[keep], bv[keep], ovf[keep]
            cur, stack, sp = cur[keep], stack[keep], sp[keep]
    return t_out, prim_out, u_out, v_out


def traverse_any(pbvh: PackedBvh, orig, dir, t_min, t_max, mask, count=None):
    """Any hit (occlusion) with early out per lane: True where some triangle
    lies in (t_min, t_max). A stack overflow reports occluded, a visible
    artifact rather than a light leak. Returns (R,) bool, False where mask
    is False. count as in traverse_closest."""
    R = orig.shape[0]
    occ_out = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    lanes = torch.nonzero(mask).flatten()
    o, d, tmn, tmx = orig[lanes], dir[lanes], t_min[lanes], t_max[lanes]
    inv = 1.0 / d
    occ = torch.zeros_like(lanes, dtype=torch.bool)
    cur, stack, sp, limit = _start_lanes(pbvh, lanes)
    L = pbvh.leaf_size

    while lanes.numel():
        if count is not None:
            count.step(cur)
        is_leaf = cur < 0
        is_int = ~is_leaf
        next_int, pushes = _node_phase(pbvh, cur, is_int, o, inv, tmn, tmx)
        for code, push in pushes:
            sp, o_flow = _push(stack, sp, limit, code, push)
            occ |= o_flow

        leaf_id = torch.where(is_leaf, -cur - 1, torch.zeros_like(cur))
        hit, _, _, _, _ = _mt_rows(pbvh.leaf_rows[leaf_id.long()], L, o, d, tmn, tmx)
        occ |= is_leaf & hit.any(dim=1)

        descend = is_int & (next_int != _DONE)
        can_pop = ~descend & (sp > 0) & ~occ
        sp = torch.where(can_pop, sp - 1, sp)
        popped = stack.gather(1, sp[:, None].long())[:, 0]
        cur = torch.where(descend, next_int, torch.where(can_pop, popped, torch.full_like(cur, _DONE)))
        cur = torch.where(occ, torch.full_like(cur, _DONE), cur)

        done = cur == _DONE
        if bool(done.any()):
            occ_out[lanes[done]] = occ[done]
            keep = ~done
            lanes, o, d, inv, tmn, tmx = lanes[keep], o[keep], d[keep], inv[keep], tmn[keep], tmx[keep]
            occ, cur, stack, sp = occ[keep], cur[keep], stack[keep], sp[keep]
    return occ_out


def unified_stack_limit(ubvh: UnifiedBvh) -> int:
    """Short-stack size of the two-level traversal: one slot per certified
    level, capped at 2 * STACK_DEPTH, as the XLA oracle's."""
    return max(2, min(2 * STACK_DEPTH, int(ubvh.stack_bound) + 1))


def _instance_entry(rows, orig, dir):
    """Decode gathered instance-entry rows: the WORLD ray through the 3x4
    world-to-object matrix at cols [0, 12), summed left to right as the
    oracle does; directions are not renormalized, so object t is world t.
    Returns (o_obj, d_obj, blas_root, inst_id)."""

    def lin(k, x):  # row k of the 3x3 part times x
        return rows[:, 4 * k] * x[:, 0] + rows[:, 4 * k + 1] * x[:, 1] + rows[:, 4 * k + 2] * x[:, 2]

    o = torch.stack([lin(k, orig) + rows[:, 4 * k + 3] for k in range(3)], dim=1)
    d = torch.stack([lin(k, dir) for k in range(3)], dim=1)
    codes = rows.view(torch.int32)
    return o, d, codes[:, 12], codes[:, 13]


def _unified_advance(ubvh: UnifiedBvh, cur, is_entry, descend, next_int, can_pop, stack, sp,
                     rows, world_o, world_d, o, d):
    """One step's move of the two-level walk: an entry leaf jumps to its
    BLAS root in object space, an internal row descends into its nearest
    hit child, anything else pops. The world ray comes back whenever the
    new cur is a TLAS row or an entry leaf. Returns (cur, sp, o, d,
    entered instance id)."""
    sp = torch.where(can_pop, sp - 1, sp)
    popped = stack.gather(1, sp[:, None].long())[:, 0]
    o_ent, d_ent, root, ent_inst = _instance_entry(rows, world_o, world_d)
    cur = torch.where(
        is_entry, root,
        torch.where(descend, next_int, torch.where(can_pop, popped, torch.full_like(cur, _DONE))),
    )
    o = torch.where(is_entry[:, None], o_ent, o)
    d = torch.where(is_entry[:, None], d_ent, d)
    world = (cur >= ubvh.tlas_lo) | ((cur < 0) & (-cur - 1 >= ubvh.n_tri_leaves))
    o = torch.where(world[:, None], world_o, o)
    d = torch.where(world[:, None], world_d, d)
    return cur, sp, o, d, ent_inst


def _unified_start(ubvh: UnifiedBvh, lanes):
    """Initial (cur, stack, sp, limit) for n live lanes: the TLAS root."""
    n = lanes.shape[0]
    limit = unified_stack_limit(ubvh)
    cur = torch.full((n,), ubvh.tlas_lo, dtype=torch.int32, device=lanes.device)
    stack = torch.full((n, limit), _DONE, dtype=torch.int32, device=lanes.device)
    sp = torch.zeros((n,), dtype=torch.int32, device=lanes.device)
    return cur, stack, sp, limit


def traverse_closest_unified(ubvh: UnifiedBvh, orig, dir, t_min, active, t_max, count=None):
    """Closest hit over a two-level table (the XLA oracle's
    traverse_closest_unified, lane by lane in lockstep). Returns (t, prim,
    inst, u, v): prim is the global triangle id; a miss or inactive lane is
    (T_MAX, -1, -1, 0, 0); a stack overflow is prim = -2, otherwise as a
    miss. count as in traverse_closest."""
    R = orig.shape[0]
    dev = orig.device
    t_out = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    prim_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    inst_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    L, n_tri = ubvh.leaf_size, ubvh.n_tri_leaves

    lanes = torch.nonzero(active).flatten()
    wo, wd, tmn = orig[lanes], dir[lanes], t_min[lanes]
    o, d = wo, wd
    bt = torch.minimum(t_out, t_max)[lanes]
    bp = torch.full_like(lanes, -1, dtype=torch.int32)
    bi = torch.full_like(bp, -1)
    reg = torch.zeros_like(bp)  # instance whose object space o, d hold
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    ovf = torch.zeros_like(lanes, dtype=torch.bool)
    cur, stack, sp, limit = _unified_start(ubvh, lanes)

    while lanes.numel():
        if count is not None:
            count.step(cur)
        is_leaf = cur < 0
        is_int = ~is_leaf
        is_tri = is_leaf & (-cur - 1 < n_tri)
        is_entry = is_leaf & ~is_tri
        next_int, pushes = _node_phase(ubvh, cur, is_int, o, 1.0 / d, tmn, bt)
        for code, push in pushes:
            sp, o_flow = _push(stack, sp, limit, code, push)
            ovf |= o_flow

        leaf_id = torch.where(is_leaf, -cur - 1, torch.zeros_like(cur))
        rows = ubvh.leaf_rows[leaf_id.long()]
        lt, lp, lu, lv = _leaf_closest(rows, L, o, d, tmn, bt)
        take = is_tri & (lt < bt)
        bt = torch.where(take, lt, bt)
        bp = torch.where(take, lp, bp)
        bi = torch.where(take, reg, bi)
        bu = torch.where(take, lu, bu)
        bv = torch.where(take, lv, bv)

        descend = is_int & (next_int != _DONE)
        can_pop = ~descend & ~is_entry & (sp > 0)
        cur, sp, o, d, ent_inst = _unified_advance(
            ubvh, cur, is_entry, descend, next_int, can_pop, stack, sp, rows, wo, wd, o, d
        )
        reg = torch.where(is_entry, ent_inst, reg)

        done = cur == _DONE
        if bool(done.any()):
            idx = lanes[done]
            p = torch.where(ovf[done], torch.full_like(bp[done], -2), bp[done])
            miss = p < 0
            t_out[idx] = torch.where(miss, torch.full_like(bt[done], T_MAX), bt[done])
            prim_out[idx] = p
            inst_out[idx] = torch.where(miss, torch.full_like(p, -1), bi[done])
            u_out[idx] = torch.where(miss, torch.zeros_like(bu[done]), bu[done])
            v_out[idx] = torch.where(miss, torch.zeros_like(bv[done]), bv[done])
            keep = ~done
            lanes, wo, wd, o, d, tmn = lanes[keep], wo[keep], wd[keep], o[keep], d[keep], tmn[keep]
            bt, bp, bi, reg, bu, bv = bt[keep], bp[keep], bi[keep], reg[keep], bu[keep], bv[keep]
            ovf, cur, stack, sp = ovf[keep], cur[keep], stack[keep], sp[keep]
    return t_out, prim_out, inst_out, u_out, v_out


def traverse_any_unified(ubvh: UnifiedBvh, orig, dir, t_min, t_max, mask, count=None):
    """Any hit (occlusion) over a two-level table with early out per lane
    (the XLA oracle's traverse_any_unified). A stack overflow reports
    occluded. Returns (R,) bool, False where mask is False. count as in
    traverse_closest."""
    R = orig.shape[0]
    occ_out = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    L, n_tri = ubvh.leaf_size, ubvh.n_tri_leaves
    lanes = torch.nonzero(mask).flatten()
    wo, wd, tmn, tmx = orig[lanes], dir[lanes], t_min[lanes], t_max[lanes]
    o, d = wo, wd
    occ = torch.zeros_like(lanes, dtype=torch.bool)
    cur, stack, sp, limit = _unified_start(ubvh, lanes)

    while lanes.numel():
        if count is not None:
            count.step(cur)
        is_leaf = cur < 0
        is_int = ~is_leaf
        is_tri = is_leaf & (-cur - 1 < n_tri)
        is_entry = is_leaf & ~is_tri
        next_int, pushes = _node_phase(ubvh, cur, is_int, o, 1.0 / d, tmn, tmx)
        for code, push in pushes:
            sp, o_flow = _push(stack, sp, limit, code, push)
            occ |= o_flow

        leaf_id = torch.where(is_leaf, -cur - 1, torch.zeros_like(cur))
        rows = ubvh.leaf_rows[leaf_id.long()]
        hit, _, _, _, _ = _mt_rows(rows, L, o, d, tmn, tmx)
        occ |= is_tri & hit.any(dim=1)

        descend = is_int & (next_int != _DONE)
        can_pop = ~descend & ~is_entry & (sp > 0) & ~occ
        cur, sp, o, d, _ = _unified_advance(
            ubvh, cur, is_entry, descend, next_int, can_pop, stack, sp, rows, wo, wd, o, d
        )
        cur = torch.where(occ, torch.full_like(cur, _DONE), cur)

        done = cur == _DONE
        if bool(done.any()):
            occ_out[lanes[done]] = occ[done]
            keep = ~done
            lanes, wo, wd, o, d = lanes[keep], wo[keep], wd[keep], o[keep], d[keep]
            tmn, tmx, occ = tmn[keep], tmx[keep], occ[keep]
            cur, stack, sp = cur[keep], stack[keep], sp[keep]
    return occ_out


def _expand_bits_10(v):
    """Spread the low 10 bits of v with two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def ray_sort_key(orig, dir, active):
    """The wavefront's int64 sort key. Most significant first: inactive bit
    (bit 30), coarse origin Morton (top 18 of 27 bits, bits 12-29),
    direction octant (bits 9-11), fine origin Morton (low 9 bits). The
    origins are quantised to 9 bits an axis between the min and max of all
    lanes, dead ones included. The key never reaches bit 31, so it fits an
    int32 (R2, csrc/sort.cu)."""
    octant = (
        (dir[:, 0] < 0).to(torch.int64) * 4
        + (dir[:, 1] < 0).to(torch.int64) * 2
        + (dir[:, 2] < 0).to(torch.int64)
    )
    lo = orig.min(dim=0).values
    hi = orig.max(dim=0).values
    scale = 511.0 / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((orig - lo) * scale, 0.0, 511.0).to(torch.int64)
    morton = (
        (_expand_bits_10(q[:, 0]) << 2)
        | (_expand_bits_10(q[:, 1]) << 1)
        | _expand_bits_10(q[:, 2])
    )
    return (
        ((~active).to(torch.int64) << 30)
        | ((morton >> 9) << 12)
        | (octant << 9)
        | (morton & 0x1FF)
    )


def ray_sort_perm_only(orig, dir, active):
    """Stable sort permutation of the wavefront by ray_sort_key."""
    return torch.argsort(ray_sort_key(orig, dir, active), stable=True)
