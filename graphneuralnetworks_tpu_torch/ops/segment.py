"""Gather and segment reductions in plain PyTorch.

Counterpart of ``graphneuralnetworks_tpu/ops/segment.py``, with the same
semantics: ``mask`` (one bool per row of ``data``) excludes rows from the
math, an empty segment sums to 0, ``mean`` divides by the true count of
rows, and ``max``/``min`` give ``empty_value`` for an empty segment. These
are the plain versions the kernels are held to. The port's graphs carry no
padding: the message-passing layer passes a graph's ``edge_valid`` as the
mask, and None where it has none.

``segment_max``, ``segment_min`` and ``segment_softmax`` also take a CSR
``indptr`` (``int32[num_segments + 1]``) that groups the rows of ``data``
segment by segment (the receiver grouping of receiver-sorted edges, or the
graph grouping of a batch), and ``eid``, the row of ``data`` at each CSR
position where that is not the position itself (``graph.csr_view``: a
reversed graph's receiver CSR, or one compacted to an ``edge_valid``
graph's valid edges, whose left-out rows ``mask`` must mask). Given
``indptr``, a CUDA tensor reduces on the K14 kernel
(``ops/cuda/segment.py``); without one, or on the CPU, the reduction is
PyTorch's ``scatter_reduce`` over arbitrary ids, as JAX's is XLA's. Their gradient splits a cotangent evenly over an extreme's ties,
counted as JAX counts them (``extreme_grad``: a bfloat16 count stops at
256), where PyTorch's own gradient, kept for float32 and float64, counts
exactly.

Every reduction takes JAX's ``sorted=`` keyword (``indices_are_sorted``,
a hint to XLA) and ignores it: the results here do not depend on the order
of the ids.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from .cuda.segment import SegmentMaxFunction

__all__ = ["gather", "count_as", "extreme_grad", "segment_sum",
           "segment_mean",
           "segment_max", "segment_min", "segment_prod", "segment_reduce",
           "segment_softmax", "AGGREGATIONS"]


def _kernel_route(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``: ``[N, ...]`` and ``int[E]`` -> ``[E, ...]``."""
    return x.index_select(0, idx)


def _masked(data, mask, fill):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.dim() - 1))
    return torch.where(m, data, torch.full_like(data, fill))


def _out(data, num_segments, fill):
    return data.new_full((num_segments,) + tuple(data.shape[1:]), fill)


def segment_sum(data, segment_ids, num_segments, *, mask=None, sorted=False):
    """Masked segment sum; empty segments get 0."""
    data = _masked(data, mask, 0)
    return _out(data, num_segments, 0).index_add(0, segment_ids, data)


def count_as(counts: torch.Tensor, dtype) -> torch.Tensor:
    """Exact counts as ``dtype`` holds a sum of that many ones, the way the
    JAX package counts degrees and means (a scatter-add of ones in
    ``dtype``): a floating sum stops at ``2 / eps`` (the first integer whose
    successor rounds back to it: 256 in bfloat16, 2048 in float16, 2^24 in
    float32), so the count is clamped there, then cast. Integer counts
    (``diff`` of a CSR's offsets) need no scatter."""
    if dtype.is_floating_point:
        stop = int(2 / torch.finfo(dtype).eps)
        if stop <= torch.iinfo(counts.dtype).max:   # else past any count
            counts = counts.clamp(max=stop)
    return counts.to(dtype)


def segment_mean(data, segment_ids, num_segments, *, mask=None,
                 sorted=False):
    """Masked segment mean dividing by the true segment size; empty -> 0."""
    s = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = data.new_ones(data.shape[:1])
    cnt = segment_sum(ones, segment_ids, num_segments, mask=mask)
    cnt = cnt.clamp(min=1)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))


def extreme_grad(data, out, segment_ids, dy):
    """The gradient of a segment max or min ``out`` of ``data``: ``dy`` of
    each output split evenly over the rows that equal it (ties), 0 for the
    others and for a NaN output. The ties are counted as :func:`count_as`
    counts in ``dy``'s type, as JAX's gradient of its segment max counts
    them (a scatter-add of ones): a bfloat16 count stops at 256. K14's
    backward kernel computes the same."""
    hit = data == out.index_select(0, segment_ids)
    count = torch.zeros(out.shape, dtype=torch.int32,
                        device=out.device).index_add_(
        0, segment_ids, hit.to(torch.int32))
    share = dy / count_as(count, dy.dtype).clamp(min=1)
    return torch.where(hit, share.index_select(0, segment_ids), 0)


class _ScatterExtreme(torch.autograd.Function):
    """``apply(data, segment_ids, num_segments, op_min)``: PyTorch's
    ``scatter_reduce`` max (min), ``-inf`` (``+inf``) for an empty segment,
    with the gradient of :func:`extreme_grad`. Taken for 16-bit floats,
    whose tie counts stop where JAX's do; PyTorch's own gradient counts
    them exactly."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, op_min):
        idx = segment_ids.reshape(segment_ids.shape
                                  + (1,) * (data.dim() - 1))
        fill = float("inf") if op_min else float("-inf")
        out = _out(data, num_segments, fill).scatter_reduce(
            0, idx.expand_as(data), data, "amin" if op_min else "amax",
            include_self=False)
        ctx.save_for_backward(data, out, segment_ids)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        data, out, segment_ids = ctx.saved_tensors
        return extreme_grad(data, out, segment_ids, dy), None, None, None


def _segment_extreme(op_min: bool, data, segment_ids, num_segments, *,
                     mask=None, empty_value=0.0, indptr=None, eid=None):
    fill = float("inf") if op_min else float("-inf")
    data = _masked(data, mask, fill)
    if indptr is not None and indptr.numel() != num_segments + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries for "
                         f"{num_segments} segments")
    if segment_ids.shape[0] != data.shape[0]:
        # the kernel trusts indptr[-1] == rows of data, which a CSR built
        # with segment_ids (the graph's receivers or node_graph_id) has
        raise ValueError(f"{segment_ids.shape[0]} segment ids for "
                         f"{data.shape[0]} rows of data")
    if indptr is not None and _kernel_route(data):
        out = SegmentMaxFunction.apply(data, indptr, op_min, eid)
    elif data.dtype in (torch.bfloat16, torch.float16):
        out = _ScatterExtreme.apply(data, segment_ids, num_segments, op_min)
    else:
        idx = segment_ids.reshape(segment_ids.shape
                                  + (1,) * (data.dim() - 1))
        out = _out(data, num_segments, fill).scatter_reduce(
            0, idx.expand_as(data), data, "amin" if op_min else "amax",
            include_self=False)
    if empty_value is not None:
        # untouched or fully masked segments come back as +-inf
        out = torch.where(out == fill, torch.full_like(out, empty_value), out)
    return out


def segment_max(data, segment_ids, num_segments, *, mask=None, sorted=False,
                empty_value=0.0, indptr=None, eid=None):
    """Masked segment max; empty segments get ``empty_value`` (None: -inf).
    With ``indptr`` (and ``eid``), K14 on the card (module docstring)."""
    return _segment_extreme(False, data, segment_ids, num_segments,
                            mask=mask, empty_value=empty_value,
                            indptr=indptr, eid=eid)


def segment_min(data, segment_ids, num_segments, *, mask=None, sorted=False,
                empty_value=0.0, indptr=None, eid=None):
    """Masked segment min; empty segments get ``empty_value`` (None: +inf).
    With ``indptr`` (and ``eid``), K14 on the card (module docstring)."""
    return _segment_extreme(True, data, segment_ids, num_segments,
                            mask=mask, empty_value=empty_value,
                            indptr=indptr, eid=eid)


def segment_prod(data, segment_ids, num_segments, *, mask=None, sorted=False):
    data = _masked(data, mask, 1)
    idx = segment_ids.reshape(segment_ids.shape + (1,) * (data.dim() - 1))
    return _out(data, num_segments, 1).scatter_reduce(
        0, idx.expand_as(data), data, "prod", include_self=True)


AGGREGATIONS: dict[str, Callable] = {
    "sum": segment_sum,
    "add": segment_sum,
    "+": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
    "prod": segment_prod,
    "*": segment_prod,
}


def aggregation(aggr) -> Callable:
    """The segment function of ``aggr`` (a name, an alias or a callable
    such as ``max``); raises ``ValueError`` on an unknown one."""
    if callable(aggr):
        aggr = getattr(aggr, "__name__", str(aggr))
    try:
        return AGGREGATIONS[str(aggr)]
    except KeyError:
        raise ValueError(f"unknown aggregation {aggr!r}; "
                         f"expected one of {list(AGGREGATIONS)}") from None


def is_extreme(aggr) -> bool:
    """Whether ``aggr`` is max or min, the reductions K14 takes."""
    return aggregation(aggr) in (segment_max, segment_min)


def segment_reduce(aggr, data, segment_ids, num_segments, *, mask=None,
                   sorted=False, indptr=None, eid=None):
    """Dispatch on ``aggr`` in {sum, mean, max, min, prod} (and aliases),
    passing ``sorted`` on as JAX's does. ``indptr`` and ``eid`` reach max
    and min only; the others ignore them."""
    kw = {"indptr": indptr, "eid": eid} if is_extreme(aggr) else {}
    return aggregation(aggr)(data, segment_ids, num_segments, mask=mask,
                             sorted=sorted, **kw)


def segment_softmax(data, segment_ids, num_segments, *, mask=None,
                    sorted=False, indptr=None, eid=None):
    """Numerically stable per-segment softmax over the leading axis (JAX
    ``ops/segment.py:segment_softmax``): segment max, exp of the shifted
    values, segment sum, normalise; masked entries give 0.

    The max only shifts the exponent, which the softmax does not see, so no
    gradient flows through it (exact arithmetic gives it none either): on
    the card with ``indptr`` it is one K14 forward and no backward.
    """
    mx = segment_max(data.detach(), segment_ids, num_segments, mask=mask,
                     empty_value=0.0, indptr=indptr, eid=eid)
    ex = torch.exp(data - gather(mx, segment_ids))
    ex = _masked(ex, mask, 0)
    denom = segment_sum(ex, segment_ids, num_segments)
    denom = denom.clamp(min=torch.finfo(ex.dtype).tiny)
    return ex / gather(denom, segment_ids)
