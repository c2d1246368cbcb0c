"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``ops.cuda.spmm`` is the SpMM module (K1, K2), ``ops.cuda.edge_softmax``
the attention module (K3 to K12), ``ops.cuda.sddmm`` the per-edge dot
(K13) and ``ops.cuda.segment`` the per-row max and min over a CSR (K14 and
its backward); each ``launches`` dict counts its kernel launches. The function
named like the module is ``ops.cuda.spmm.spmm``.
"""

from . import build, edge_softmax, gather, sddmm, segment, spmm
from .gather import fast_gather

__all__ = ["build", "edge_softmax", "gather", "sddmm", "segment", "spmm",
           "fast_gather"]
