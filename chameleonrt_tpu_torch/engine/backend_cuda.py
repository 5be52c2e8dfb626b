"""The `cuda` backend: the wavefront path tracer with native SAH BVH tables
and the hand-written CUDA traversal kernels; the counterpart of
chameleonrt_tpu/engine/backend_tpu.py. A single-instance scene traces its
one mesh's table (kernels B1 and B2, or B5a and B5b of the streamed tier
where the table exceeds the card's L2); a multi-instance scene traces one
two-level TLAS+BLAS table (kernels B3 and B4, or B5c and B5d of the
streamed tier where that table exceeds the card's L2).

On device="cpu" it runs the same code with the plain traversal, which is
how the CPU tests hold it against the JAX `tpu` backend.
"""

from __future__ import annotations

from typing import Optional

from chameleonrt_tpu_torch.engine.backend_base import TorchRenderBackend
from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
from chameleonrt_tpu_torch.engine.trace_bvh import build_blas_set, make_trace_fns
from chameleonrt_tpu_torch.scene.types import Scene


class CudaBackend(TorchRenderBackend):
    def __init__(self, device="cuda", use_kernels: bool = True, stream: Optional[bool] = None):
        """use_kernels=False traces with the plain torch traversal on any
        device; the card's parity checks use it. stream picks the tier:
        True the streamed tier (B5a/B5b flat, B5c/B5d two-level), False
        B1/B2 flat and B3/B4 two-level, None (the default) by the gate
        trace_bvh.streamed_tier on the scene's BVH4 table."""
        super().__init__(device=device)
        self.use_kernels = use_kernels
        self.stream = stream

    @property
    def name(self) -> str:
        return "CUDA wavefront (SAH BVH4)"

    def prepare_scene(self, scene: Scene):
        flat, meta = build_device_scene(scene, self.device)
        return flat._replace(blas=build_blas_set(flat, meta)), meta

    def make_trace_fns(self, meta):
        return make_trace_fns(meta, use_kernels=self.use_kernels, stream=self.stream,
                              blas=self.flat.blas)
