"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``ops.cuda.spmm`` is the SpMM module (its ``launches`` counts kernel
launches); the function of the same name is ``ops.cuda.spmm.spmm``.
"""

from . import build, gather, spmm
from .gather import fast_gather

__all__ = ["build", "gather", "spmm", "fast_gather"]
