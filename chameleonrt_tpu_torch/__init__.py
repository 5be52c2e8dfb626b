"""ChameleonRT on PyTorch and CUDA: the port of chameleonrt_tpu to one NVIDIA GPU.

Same scene loaders, backend contract and rendering algorithm as the JAX
package (which it imports for its JAX-free host layers: scene/, core/,
native.py and utils/image_io.py), with PyTorch in place of JAX and
hand-written CUDA kernels for BVH traversal. Importing the package
registers the `cuda` render backend.
"""

from chameleonrt_tpu.core.registry import register_backend

__version__ = "0.1.0"


def _cuda_backend(**kwargs):
    from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend

    return CudaBackend(**kwargs)


register_backend("cuda", _cuda_backend)
