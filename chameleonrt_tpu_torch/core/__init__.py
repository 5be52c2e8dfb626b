from chameleonrt_tpu_torch.core.backend import CameraPose, RenderBackend, RenderStats  # noqa: F401
from chameleonrt_tpu_torch.core.registry import get_backend, list_backends, register_backend  # noqa: F401
