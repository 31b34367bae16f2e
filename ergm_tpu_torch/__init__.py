"""ERGM in PyTorch and CUDA: the port of ``ergm_tpu`` to an NVIDIA H100.

The package mirrors ``ergm_tpu``'s module paths and function names.
Plain tensor code is PyTorch and runs on the CPU too; every Pallas
kernel of ``ergm_tpu`` on a ported path becomes a kernel written by
hand for Hopper (``csrc/``), built at first use. The package never
imports JAX.
"""

__version__ = "0.1.0"

from ergm_tpu_torch.core.config import ModelConfig  # noqa: F401
