"""LBVH construction on the tables' device (torch): the counterpart of
chameleonrt_tpu/ops/lbvh.py, the fallback for a host with no C++ compiler,
where the native SAH builder (native.py) cannot be built.

1. 30-bit Morton codes of the triangle centroids quantised to a 1024^3
   grid over the scene bounds (morton_codes);
2. a stable sort of the codes, so that a run of equal codes keeps index
   order;
3. uniform leaves of LEAF_SIZE consecutive sorted triangles;
4. the Karras (2012) hierarchy over the leaves' first codes, every
   internal node at once (_build_karras: binary searches on the common
   prefix length, ties broken by the index);
5. a bottom-up refit of the boxes, one pass per level (_refit).

The tables are bit-equal to the JAX package's over the same triangles.
torch has no full uint32 arithmetic, so the codes live in int64 under the
same masks: they fit in 30 bits, and every XOR of two codes or two
indices in 32, so every bit is the same. The node layout (Bvh) is the
JAX package's: internal nodes [0, N-2], root 0; leaf k is node (N-1)+k and
covers sorted triangle positions [k*LEAF_SIZE, (k+1)*LEAF_SIZE).

pack_bvh emits the port's PackedBvh with binary 16-float rows and a
certified max_depth: the tree's height in internal levels, which the
refit's pass count gives exactly (the JAX package's tables carry None).
The kernels size their stacks from it, as from a native build's. Within a
Karras tree every internal child's prefix length exceeds its parent's,
and it lies in [2, 63] (30-bit codes, then 32 + clz of the indices' XOR),
so no path holds more than 62 internal nodes: the stack fits the
kernels' 64-entry instantiation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from chameleonrt_tpu_torch.engine.device_scene import PackedBvh

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
    their device: one mesh's table."""
    tmin, tmax = triangle_aabbs(v0, e1, e2)
    return pack_bvh(build_bvh(tmin, tmax, leaf_size), v0, e1, e2)
