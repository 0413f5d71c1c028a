"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the dispatcher: CUDA tensors launch the kernel (or raise), CPU
tensors run the plain version in ``ref``. Kernels build at first use
(``build``), never at import.
"""
from repro_torch.kernels import ref  # noqa: F401
