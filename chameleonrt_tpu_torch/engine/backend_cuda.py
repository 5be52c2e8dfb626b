"""The `cuda` backend: the wavefront path tracer with native SAH BVH tables
and the hand-written CUDA traversal kernels; the counterpart of
chameleonrt_tpu/engine/backend_tpu.py. A single-instance scene traces its
one mesh's table (kernels B1 and B2, or B5a and B5b of the streamed tier
where the table exceeds the card's L2); a multi-instance scene traces one
two-level TLAS+BLAS table (kernels B3 and B4, or B5c and B5d of the
streamed tier where that table exceeds the card's L2). With the slot-lane
tier off (slotlane=False, or CHAMELEONRT_SLOTLANE=0 in the environment, as
for the JAX package) the work-queue kernels trace instead: B6a and B6b
flat, B6c and B6d two-level. With grid_packet=True a flat scene traces its
binary table through the grid-packet kernels B7a and B7b. The JAX
engine's table switches hold here too (engine/trace_bvh.py):
CHAMELEONRT_CLOSEST_ARITY, CHAMELEONRT_WIDE_ARITY, CHAMELEONRT_LEAF_SIZE,
and CHAMELEONRT_PACKET=0, which traces with the plain traversal. On a
host with no C++ compiler, where the native SAH builder cannot be built,
each mesh gets an LBVH built on the device instead, whose binary table
the same kernels trace (B1/B2 by default; instance by instance in a
multi-instance scene).

On device="cpu" it runs the same code with the plain traversal, which is
how the CPU tests hold it against the JAX `tpu` backend.
"""

from __future__ import annotations

from typing import Optional

from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine.backend_base import TorchRenderBackend
from chameleonrt_tpu_torch.engine.device_scene import UnifiedPair, build_device_scene
from chameleonrt_tpu_torch.engine.trace_bvh import (
    build_blas_set,
    compute_instance_aabbs,
    kernels_enabled,
    make_trace_fns,
)
from chameleonrt_tpu_torch.scene.types import Scene


class CudaBackend(TorchRenderBackend):
    def __init__(self, device="cuda", use_kernels: bool = True, stream: Optional[bool] = None,
                 slotlane: Optional[bool] = None, grid_packet: bool = False, devices=0,
                 rebalance: bool = False):
        """use_kernels=False traces with the plain torch traversal on any
        device; the card's parity checks use it. stream picks the tier:
        True the streamed tier (B5a/B5b flat, B5c/B5d two-level), False
        B1/B2 flat and B3/B4 two-level, None (the default) by the gate
        trace_bvh.streamed_tier on the scene's BVH4 table. slotlane=False
        replaces all of these with the work-queue kernels (B6a/B6b flat,
        B6c/B6d two-level) and stream is then not read; None (the default)
        reads CHAMELEONRT_SLOTLANE (trace_bvh.slotlane_enabled).
        grid_packet=True traces a flat scene's binary table through B7a and
        B7b, whatever stream and slotlane say, and refuses a multi-instance
        scene (trace_bvh.make_trace_fns). CHAMELEONRT_PACKET=0 (read at
        set_scene) acts as use_kernels=False. devices and rebalance split
        the frame over a mesh of devices (TorchRenderBackend)."""
        super().__init__(device=device, devices=devices, rebalance=rebalance)
        self.use_kernels = use_kernels
        self.stream = stream
        self.slotlane = slotlane
        self.grid_packet = grid_packet

    @property
    def name(self) -> str:
        """Names the tables set_scene builds: SAH BVH4 with a C++ compiler,
        else LBVH (native.compiler() looks it up, and builds nothing)."""
        if native.compiler() is None:
            return "CUDA wavefront (LBVH: no native builder)"
        return "CUDA wavefront (SAH BVH4)"

    def prepare_scene(self, scene: Scene):
        flat, meta = build_device_scene(scene, self.device)
        blas = build_blas_set(flat, meta)
        flat = flat._replace(blas=blas)
        if meta.num_instances > 1 and not isinstance(blas[0], UnifiedPair):
            flat = flat._replace(inst_aabb=compute_instance_aabbs(flat, meta))
        return flat, meta

    def make_trace_fns(self, meta, flat=None):
        flat = self.flat if flat is None else flat
        return make_trace_fns(meta, use_kernels=self.use_kernels and kernels_enabled(),
                              stream=self.stream, blas=flat.blas, slotlane=self.slotlane,
                              grid_packet=self.grid_packet)
