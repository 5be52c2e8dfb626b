"""The plain reference's BVH: an LBVH built on the device from the scene's
own triangles, and the plain lockstep walks over it.

Frozen copies of chameleonrt_tpu_torch/ops/lbvh.py (build_bvh, pack_bvh)
and of the flat walks of chameleonrt_tpu_torch/ops/traverse.py
(traverse_closest, traverse_any) as of this benchmark's first version,
with two departures: the stack holds the tree's whole height (an LBVH
path holds at most 62 internal nodes, so a walk never overflows), and the
walks record no WalkCount. The reference builds this table itself from
the scene generator's triangles; it takes no table from the program. Any
BVH gives the same closest hit up to ties between triangles at equal t,
and the same occlusion answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Moller-Trumbore constants (chameleonrt_tpu_torch/ops/intersect.py)
T_MAX = 1e20
_MT_EPS = 1e-9
UV_EPS = 3.999999989900971e-06  # float32(4e-6)
ONE_PLUS_UV_EPS = 1.0000040531158447  # float32(1) + float32(4e-6)


class PackedBvh(NamedTuple):
    """Binary node rows [left box, right box, left code, right code, 0, 0]
    (a code >= 0 is a node row, c < 0 leaf -(c+1)) and component-major
    leaf rows of LEAF_SIZE slots (v0, e1, e2, prim id bitcast)."""

    nodes: torch.Tensor
    leaf_rows: torch.Tensor
    max_depth: int

    @property
    def arity(self) -> int:
        return self.nodes.shape[1] // 8

    @property
    def num_leaves(self) -> int:
        return self.leaf_rows.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.leaf_rows.shape[1] // 10


LEAF_SIZE = 4


class Bvh(NamedTuple):
    """Flat binary BVH over one triangle range, structure of arrays."""

    node_min: torch.Tensor  # (2N-1, 3) float32
    node_max: torch.Tensor  # (2N-1, 3) float32
    node_left: torch.Tensor  # (2N-1,) int64, valid for internal nodes
    node_right: torch.Tensor  # (2N-1,) int64
    prim_order: torch.Tensor  # (N * LEAF_SIZE,) int64 triangle ids, -1 pad
    height: int  # internal nodes on the longest root-to-leaf path

    @property
    def num_leaves(self) -> int:
        return (self.node_left.shape[0] + 1) // 2


def triangle_aabbs(v0, e1, e2):
    """Boxes (min, max) of (v0, e1, e2)-form triangles."""
    p1 = v0 + e1
    p2 = v0 + e2
    return torch.minimum(torch.minimum(v0, p1), p2), torch.maximum(torch.maximum(v0, p1), p2)


def _expand_bits_10(v):
    """Spread the low 10 bits of v with two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids, scene_min, scene_max):
    """30-bit Morton codes (int64) of points quantised to a 1024^3 grid
    over the scene bounds."""
    extent = torch.clamp(scene_max - scene_min, min=1e-12)
    q = torch.clamp((centroids - scene_min) / extent, 0.0, 0.99999994)
    cell = (q * 1024.0).to(torch.int64)
    return ((_expand_bits_10(cell[..., 0]) << 2) | (_expand_bits_10(cell[..., 1]) << 1)
            | _expand_bits_10(cell[..., 2]))


def _clz32(x):
    """Leading zeros of x as a 32-bit word (0 <= x < 2^32, int64): the
    JAX package's five-step bit-halving loop."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        high = x >> shift
        has_high = high != 0
        n = torch.where(has_high, n, n + shift)
        x = torch.where(has_high, high, x)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def _build_karras(keys):
    """(left, right) child node ids of the N-1 internal nodes over N sorted
    codes (int64). Equal codes are told apart by position: the prefix
    length extends by clz of the indices' XOR, a 64-bit key without 64-bit
    codes."""
    N = keys.shape[0]
    i = torch.arange(N - 1, dtype=torch.int64, device=keys.device)

    def delta(a, b):
        """Common prefix length of keys a and b, extended on equal keys;
        -1 where b is out of range."""
        b_ok = (b >= 0) & (b < N)
        bc = torch.clamp(b, 0, N - 1)
        ka, kb = keys[a], keys[bc]
        d = torch.where(ka == kb, 32 + _clz32(a ^ bc), _clz32(ka ^ kb))
        return torch.where(b_ok, d, torch.full_like(d, -1))

    # direction of the range: toward the longer common prefix
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)

    # an upper bound on the range's length by doubling, then its other end
    steps = max(int(math.ceil(math.log2(max(N, 2)))) + 2, 2)
    lmax = torch.full_like(i, 2)
    for _ in range(steps):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(steps + 1):
        l = torch.where((t > 0) & (delta(i, i + (l + t) * d) > delta_min), l + t, l)
        t = t // 2
    j = i + l * d

    # the split: the highest differing bit within [min(i, j), max(i, j)]
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    tt = (l + 1) // 2
    for _ in range(steps + 1):
        s = torch.where((tt > 0) & (delta(i, i + (s + tt) * d) > delta_node), s + tt, s)
        tt = torch.where(tt > 1, (tt + 1) // 2, torch.zeros_like(tt))
    gamma = i + s * d + torch.clamp(d, max=0)

    leaf_base = N - 1
    left = torch.where(torch.minimum(i, j) == gamma, leaf_base + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left, right


def _refit(node_left, node_right, leaf_min, leaf_max, n_leaves):
    """Bottom-up boxes: each pass fills every internal node whose two
    children are filled, until a pass fills none (the root is then
    filled: one pass per level). Returns (node_min, node_max, height):
    pass k fills the nodes with k internal levels at and below them, so
    the filling passes count the root's height."""
    n_internal = n_leaves - 1
    total = 2 * n_leaves - 1
    dev = leaf_min.device
    node_min = torch.full((total, 3), float("inf"), dtype=torch.float32, device=dev)
    node_max = torch.full((total, 3), float("-inf"), dtype=torch.float32, device=dev)
    node_min[n_internal:] = leaf_min
    node_max[n_internal:] = leaf_max
    ready = torch.zeros(total, dtype=torch.bool, device=dev)
    ready[n_internal:] = True
    lc, rc = node_left[:n_internal], node_right[:n_internal]
    height = 0
    while True:
        can = ready[lc] & ready[rc] & ~ready[:n_internal]
        if not bool(can.any()):
            break
        idx = can.nonzero().flatten()
        node_min[idx] = torch.minimum(node_min[lc[idx]], node_min[rc[idx]])
        node_max[idx] = torch.maximum(node_max[lc[idx]], node_max[rc[idx]])
        ready[idx] = True
        height += 1
    return node_min, node_max, height


def build_bvh(prim_min, prim_max, leaf_size: int = LEAF_SIZE) -> Bvh:
    """An LBVH over primitives given by their boxes (T, 3) x 2, T >= 1, on
    the boxes' device."""
    T = prim_min.shape[0]
    if T < 1:
        raise ValueError("an LBVH needs at least one primitive")
    dev = prim_min.device
    centroids = 0.5 * (prim_min + prim_max)
    codes = morton_codes(centroids, prim_min.min(dim=0).values, prim_max.max(dim=0).values)
    # stable: runs of equal codes keep index order, which _build_karras's
    # tie break relies on
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]

    n_leaves = max((T + leaf_size - 1) // leaf_size, 1)
    pad = n_leaves * leaf_size - T
    prim_order = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64, device=dev)])

    # leaf boxes over their (padded) triangle runs
    runs = prim_order.reshape(n_leaves, leaf_size)
    valid = (runs >= 0)[..., None]
    safe = torch.clamp(runs, min=0)
    run_min = torch.where(valid, prim_min[safe], float("inf")).amin(dim=1)
    run_max = torch.where(valid, prim_max[safe], float("-inf")).amax(dim=1)

    if n_leaves == 1:
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        return Bvh(run_min, run_max, zero, zero, prim_order, 0)

    # the hierarchy over each leaf run's first (sorted) code
    left, right = _build_karras(sorted_codes[::leaf_size])
    pad_nodes = torch.zeros(n_leaves, dtype=torch.int64, device=dev)
    node_left = torch.cat([left, pad_nodes])
    node_right = torch.cat([right, pad_nodes])
    node_min, node_max, height = _refit(node_left, node_right, run_min, run_max, n_leaves)
    return Bvh(node_min, node_max, node_left, node_right, prim_order, height)


def pack_bvh(bvh: Bvh, tri_v0, tri_e1, tri_e2) -> PackedBvh:
    """A built LBVH and its triangles in the port's table layout: binary
    node rows [left box, right box, left code, right code, 0, 0] (a code
    >= 0 is a node row, a code c < 0 leaf -(c+1)), and component-major leaf
    rows of LEAF_SIZE slots (v0, e1, e2, prim id bitcast; padding slots
    zero with prim -1). max_depth is the tree's height, as a native
    build's (0 for a single leaf)."""
    n_leaves = bvh.num_leaves
    leaf_size = bvh.prim_order.shape[0] // n_leaves
    dev = tri_v0.device

    def bits(x):
        return x.to(torch.int32).view(torch.float32)

    if n_leaves == 1:
        # left: leaf 0; right: an empty box
        nodes = torch.zeros((1, 16), dtype=torch.float32, device=dev)
        nodes[0, 0:3] = bvh.node_min[0]
        nodes[0, 3:6] = bvh.node_max[0]
        nodes[0, 6:9] = float("inf")
        nodes[0, 9:12] = float("-inf")
        nodes[0, 12:14] = bits(torch.full((2,), -1, dtype=torch.int64, device=dev))
    else:
        n_internal = n_leaves - 1
        leaf_base = n_leaves - 1
        left, right = bvh.node_left[:n_internal], bvh.node_right[:n_internal]

        def code(c):
            return torch.where(c >= leaf_base, -(c - leaf_base) - 1, c)

        nodes = torch.cat([
            bvh.node_min[left], bvh.node_max[left], bvh.node_min[right], bvh.node_max[right],
            bits(code(left))[:, None], bits(code(right))[:, None],
            torch.zeros((n_internal, 2), dtype=torch.float32, device=dev),
        ], dim=1)

    prim = bvh.prim_order.reshape(n_leaves, leaf_size)
    safe = torch.clamp(prim, min=0)
    tris = torch.cat([tri_v0[safe], tri_e1[safe], tri_e2[safe]], dim=-1)  # (n, L, 9)
    tris = torch.where((prim >= 0)[..., None], tris, 0.0)  # padding: never hit
    rows = torch.cat([tris, bits(prim)[..., None]], dim=-1)  # (n, L, 10) slot-major
    leaf_rows = rows.transpose(1, 2).reshape(n_leaves, 10 * leaf_size).contiguous()
    return PackedBvh(nodes=nodes, leaf_rows=leaf_rows, max_depth=bvh.height)


def build_packed(v0, e1, e2, leaf_size: int = LEAF_SIZE) -> PackedBvh:
    """triangle_aabbs, build_bvh and pack_bvh over (v0, e1, e2) (T, 3) on
    their device."""
    tmin, tmax = triangle_aabbs(v0, e1, e2)
    return pack_bvh(build_bvh(tmin, tmax, leaf_size), v0, e1, e2)


def stack_limit(pbvh: PackedBvh) -> int:
    """One stack slot per level of the tree: a walk never overflows."""
    return max(2, int(pbvh.max_depth) + 1)


_DONE = 0x7FFFFFFF  # current-node sentinel: lane finished


_BIG = 1e30  # sort key of a child whose box the ray misses


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


def traverse_closest(pbvh: PackedBvh, orig, dir, t_min, active, t_max=None):
    """Closest hit per lane. orig, dir (R, 3) f32; t_min, t_max (R,) f32;
    active (R,) bool. Returns (t, prim, u, v): a miss or inactive lane is
    (T_MAX, -1, 0, 0)."""
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


def traverse_any(pbvh: PackedBvh, orig, dir, t_min, t_max, mask):
    """Any hit (occlusion) with early out per lane: True where some triangle
    lies in (t_min, t_max). A stack overflow reports occluded, a visible
    artifact rather than a light leak. Returns (R,) bool, False where mask
    is False."""
    R = orig.shape[0]
    occ_out = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    lanes = torch.nonzero(mask).flatten()
    o, d, tmn, tmx = orig[lanes], dir[lanes], t_min[lanes], t_max[lanes]
    inv = 1.0 / d
    occ = torch.zeros_like(lanes, dtype=torch.bool)
    cur, stack, sp, limit = _start_lanes(pbvh, lanes)
    L = pbvh.leaf_size

    while lanes.numel():
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
