"""ChameleonRT on PyTorch and CUDA: the port of chameleonrt_tpu to one NVIDIA GPU.

Same scene loaders, backend contract and rendering algorithm as the JAX
package, with PyTorch in place of JAX and hand-written CUDA kernels for BVH
traversal. The port imports nothing of the JAX package: it keeps its own
copy of every host module it needs, under the same sub-package names
(scene/, core/, utils/, native.py). Its registry (core/registry.py) knows
the `cuda` render backend.
"""

__version__ = "0.1.0"
