"""Endpoint gather whose backward is the K1 kernel.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/gather.py:fast_gather``.
The forward is a plain ``x[idx]``. Its gradient is a scatter-add of edge
rows onto nodes, which here is K1 over the CSR that groups edges by
``idx``: the receiver CSR for ``x[receivers]`` (``col=eid_r``: None where
edge ids are CSR positions, rows read in order) and the sender CSR for
``x[senders]`` (``col=eid_s``; None on a reversed graph). Each node row of
the gradient is summed in a fixed order within one warp (several narrow
rows share a warp), with no atomics.

On the card the backward takes float32 only: a bfloat16 ``dy`` raises
``TypeError`` (K1 over edge rows is not among the bfloat16 routes yet;
ROADMAP.md queue 1), where a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .spmm import _BF16_NOT_PORTED, spmm_csr

__all__ = ["fast_gather"]


class _GatherFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, idx, indptr, col):
        ctx.save_for_backward(indptr, col)
        return x.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        indptr, col = ctx.saved_tensors
        if dy.is_cuda and dy.dtype == torch.bfloat16:
            raise TypeError("fast_gather's backward on the card (K1 over "
                            f"edge rows) takes float32: {_BF16_NOT_PORTED}")
        return spmm_csr(indptr, col, None, None, dy.contiguous()), None, None, None


def fast_gather(x: torch.Tensor, idx: torch.Tensor, indptr: torch.Tensor,
                col: torch.Tensor | None) -> torch.Tensor:
    """``x[idx]`` for ``x`` of shape ``[N, D]``.

    ``indptr`` (``int32[N + 1]``) and ``col`` group the edges by ``idx``:
    the edges with ``idx == i`` are ``col[indptr[i]:indptr[i+1]]`` (or those
    positions themselves when ``col`` is None).
    """
    if x.dim() != 2 or x.shape[0] != indptr.numel() - 1:
        raise ValueError(f"x {tuple(x.shape)} does not match a grouping of "
                         f"{indptr.numel() - 1} rows")
    return _GatherFunction.apply(x, idx, indptr, col)
