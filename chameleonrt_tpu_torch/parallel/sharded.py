"""Multi-device rendering (torch): the counterpart of
chameleonrt_tpu/parallel/sharded.py.

The framebuffer rows are split into equal shards over a mesh, an ordered
list of torch devices; the scene is replicated once per distinct device.
One process drives every shard, bounce by bounce, as the JAX package's
single-controller SPMD step does. A device may appear in the mesh more
than once, so that one card, or the CPU, holds several shards.

Rays are counted exactly: the rows that pad the height up to a multiple of
the mesh size start dead and trace nothing. (The JAX package's static
step traces them, wrapped onto the top rows, and scales each device's
count by its real rows instead.) With rebalance, shards swap rows of their
wavefronts between bounces (engine/path_tracer.py _exchange_wavefront),
each lane carries its id in the padded frame, and the illumination is
delivered as jax.lax.psum_scatter delivers it: shard d receives the sum
over shards of rows [d*shard_h*W, (d+1)*shard_h*W) of their partial
frames.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from chameleonrt_tpu_torch.core import tracing
from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.engine.device_scene import FlatScene, SceneMeta
from chameleonrt_tpu_torch.ops import camera as camera_ops


def make_mesh(devices) -> List[torch.device]:
    """The devices as an ordered list of torch devices, one a shard; a
    CUDA device without an index is the current one."""
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def padded_height(fb_height: int, n_dev: int) -> int:
    """Rows of the frame padded up to a multiple of the device count
    (every shard has the same number of rows)."""
    return -(-fb_height // n_dev) * n_dev


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [_to(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def replicate_scene(flat: FlatScene, mesh) -> Dict[torch.device, FlatScene]:
    """The scene on every distinct device of the mesh, by device; the
    device the scene is on keeps it as it is."""
    home = make_mesh([flat.tri_v0.device])[0]
    return {dev: flat if dev == home else _to(flat, dev) for dev in dict.fromkeys(mesh)}


def shard_accum(accum: torch.Tensor, mesh) -> List[torch.Tensor]:
    """A (padded H, W, 3) buffer as one block of rows a shard, each on its
    shard's device."""
    rows = accum.shape[0] // len(mesh)
    return [accum[d * rows:(d + 1) * rows].to(dev) for d, dev in enumerate(mesh)]


class ShardedRenderStep:
    """One progressive frame over a mesh: step(flats, view, accum_shards,
    frame_id) -> (accum_shards, rays). flats maps each device to its
    replica of the scene (replicate_scene), accum_shards are the
    shard_accum blocks of a (padded_height(H, n), W, 3) buffer, rays is
    the frame's ray count, a 0-dim int64 tensor on the mesh's first
    device. lanes_moved holds the active lanes the last frame's exchanges
    moved between shards (0 without rebalance)."""

    def __init__(self, meta: SceneMeta, trace_fns_by_device, mesh, fb_width: int,
                 fb_height: int, spp: int, rebalance: bool = False):
        self.meta = meta
        self.trace_fns = trace_fns_by_device
        self.mesh = make_mesh(mesh)
        n = len(self.mesh)
        self.shard_h = padded_height(fb_height, n) // n
        self.fb_width, self.fb_height, self.spp = fb_width, fb_height, spp
        self.rebalance = rebalance and n > 1
        self.lanes_moved = 0
        self.pixels = []
        for d, dev in enumerate(self.mesh):
            ys, xs = torch.meshgrid(torch.arange(self.shard_h, device=dev),
                                    torch.arange(fb_width, device=dev), indexing="ij")
            px = xs.reshape(-1)
            py_raw = ys.reshape(-1) + d * self.shard_h
            # padding rows (past H) seed as rows from the top and start dead
            gids = py_raw * fb_width + px if self.rebalance else None
            self.pixels.append((px, py_raw % max(fb_height, 1), gids, py_raw < fb_height))

    def __call__(self, flats, view: camera_ops.ViewParams, accum_shards, frame_id: int):
        W, shard_h = self.fb_width, self.shard_h
        shards = [path_tracer.Shard(flats[dev], *self.trace_fns[dev], *pix)
                  for dev, pix in zip(self.mesh, self.pixels)]
        rows = shard_h * W
        illums, rays, self.lanes_moved = path_tracer.render_shards(
            self.meta, shards, view, frame_id, W, self.fb_height, self.spp,
            scatter_rows=len(self.mesh) * rows, rebalance=self.rebalance,
        )
        with tracing.span("frame.accumulate"):
            if self.rebalance:
                illums = [sum(part[d * rows:(d + 1) * rows].to(dev) for part in illums)
                          for d, dev in enumerate(self.mesh)]
            accum = [path_tracer.progressive_accum(a, illum.reshape(shard_h, W, 3), frame_id)
                     for a, illum in zip(accum_shards, illums)]
            home = self.mesh[0]
            return accum, sum(r.to(home) for r in rays)


def make_sharded_render_step(meta: SceneMeta, trace_fns_by_device, mesh, fb_width: int,
                             fb_height: int, spp: int, rebalance: bool = False):
    """The sharded frame step (ShardedRenderStep). trace_fns_by_device maps
    each device of the mesh to its (trace_closest, trace_any)."""
    return ShardedRenderStep(meta, trace_fns_by_device, mesh, fb_width, fb_height, spp,
                             rebalance)
