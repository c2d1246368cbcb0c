"""Endpoint gather whose backward is the K1 kernel.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/gather.py:fast_gather``.
The forward is a plain ``x[idx]``. Its gradient is a scatter-add of edge
rows onto nodes, which here is K1 over the CSR that groups edges by
``idx``: the receiver CSR for ``x[receivers]`` (``col=eid_r``: None where
edge ids are CSR positions, rows read in order) and the sender CSR for
``x[senders]`` (``col=eid_s``; None on a reversed graph). Each node row of
the gradient is summed in a fixed order within one warp (several narrow
rows share a warp), with no atomics.

A bfloat16 ``dy`` takes K1's bfloat16 variant (``spmm_csr_bf16``: float32
sums, each node row rounded once), as JAX's ``_fg_bwd`` runs its scatter
kernel in ``dy``'s type.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .spmm import spmm_csr

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
        return (spmm_csr(indptr, col, None, None, dy.contiguous()), None,
                None, None)


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
