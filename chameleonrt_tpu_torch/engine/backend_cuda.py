"""The `cuda` backend: the wavefront path tracer with native SAH BVH tables
and the hand-written CUDA traversal kernels; the counterpart of
chameleonrt_tpu/engine/backend_tpu.py. A single-instance scene traces its
one mesh's table, a multi-instance scene one two-level TLAS+BLAS table, on
the route that its traversal value picks (engine/trace_bvh.py
choose_route). On a host with no C++ compiler, where the native SAH
builder cannot be built, each mesh gets an LBVH built on the device
instead, whose binary table the same kernels trace (instance by instance
in a multi-instance scene).

On device="cpu" it runs the same code with the plain traversal, which is
how the CPU tests hold it against the JAX `tpu` backend.
"""

from __future__ import annotations

from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.engine.backend_base import TorchRenderBackend
from chameleonrt_tpu_torch.engine.device_scene import UnifiedPair, build_device_scene
from chameleonrt_tpu_torch.engine.trace_bvh import (
    build_blas_set,
    compute_instance_aabbs,
    make_trace_fns,
)
from chameleonrt_tpu_torch.scene.types import Scene


class CudaBackend(TorchRenderBackend):
    def __init__(self, device="cuda", traversal: str = "auto", devices=0,
                 rebalance: bool = False):
        """traversal picks the route, "auto" (the default), "plain",
        "lane", "stream", "persistent" or "packet"
        (trace_bvh.choose_route); the card's parity checks trace "plain".
        devices and rebalance split the frame over a mesh of devices
        (TorchRenderBackend)."""
        super().__init__(device=device, devices=devices, rebalance=rebalance)
        self.traversal = traversal

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
        return make_trace_fns(meta, self.traversal, blas=flat.blas)
