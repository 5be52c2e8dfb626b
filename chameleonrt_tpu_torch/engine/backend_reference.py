"""The `reference` backend: the brute-force torch path tracer, the
counterpart of chameleonrt_tpu/engine/backend_reference.py.

The correctness oracle of the port: no acceleration structure, every ray
tests every triangle (engine/trace_bruteforce.py), and the image every
other backend must match. Meant for small scenes. It renders on the card
by default; device="cpu" runs it on the host.
"""

from __future__ import annotations

from chameleonrt_tpu_torch.engine.backend_base import TorchRenderBackend
from chameleonrt_tpu_torch.engine.device_scene import build_device_scene
from chameleonrt_tpu_torch.engine.trace_bruteforce import make_trace_fns
from chameleonrt_tpu_torch.scene.types import Scene


class ReferenceBackend(TorchRenderBackend):
    @property
    def name(self) -> str:
        return "Reference (brute-force torch)"

    def prepare_scene(self, scene: Scene):
        return build_device_scene(scene, self.device)

    def make_trace_fns(self, meta, flat=None):
        return make_trace_fns(meta)
