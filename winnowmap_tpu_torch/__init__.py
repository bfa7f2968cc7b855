"""winnowmap-tpu, PyTorch/CUDA port.

A second package beside the JAX reference (winnowmap_tpu/): the native C++
engine runs seeding, chaining and hit bookkeeping on the host, and every
extension-DP job it exports runs through hand-written CUDA kernels
(csrc/extd.cu, csrc/traceback.cu).  The package imports torch and numpy,
never jax and nothing of winnowmap_tpu.
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
