"""Backend plugin registry.

The reference loads backends as dlopen'd shared libraries resolved by name
(crt_<backend>, reference util/render_plugin.cpp:14-59). Here, as in
chameleonrt_tpu/core/registry.py, it is a name -> factory registry with
lazy imports, so adding a backend is registering one more entry against
the same seam. The port's registry knows the port's backends only.
Both built-in backends render on the card unless given device="cpu".
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from chameleonrt_tpu_torch.core.backend import RenderBackend

_REGISTRY: Dict[str, Callable[..., RenderBackend]] = {}

# Built-in backends: name -> "module:attribute", imported on first use.
_BUILTIN = {
    # The wavefront path tracer with native SAH tables and the hand-written
    # CUDA traversal kernels (device="cpu" runs the plain traversal).
    "cuda": "chameleonrt_tpu_torch.engine.backend_cuda:CudaBackend",
    # The brute-force oracle: every ray against every triangle, no BVH.
    "reference": "chameleonrt_tpu_torch.engine.backend_reference:ReferenceBackend",
}


def register_backend(name: str, factory: Callable[..., RenderBackend]) -> None:
    _REGISTRY[name] = factory


def list_backends():
    return sorted(set(_BUILTIN) | set(_REGISTRY))


def get_backend(name: str, **kwargs) -> RenderBackend:
    """Instantiate a backend by name (the `crt_<name>` plugin-loading seam)."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    if name in _BUILTIN:
        module_name, _, attr = _BUILTIN[name].partition(":")
        module = importlib.import_module(module_name)
        factory = getattr(module, attr)
        register_backend(name, factory)
        return factory(**kwargs)
    raise ValueError(
        f"Unknown render backend '{name}'. Available: {', '.join(list_backends())}"
    )
