"""Gather and segment reductions in plain PyTorch.

Counterpart of ``graphneuralnetworks_tpu/ops/segment.py``, with the same
semantics: ``mask`` (one bool per row of ``data``) excludes rows from the
math, an empty segment sums to 0, ``mean`` divides by the true count of
rows, and ``max``/``min`` give ``empty_value`` for an empty segment. These
are the plain versions the kernels are held to. The port's graphs carry no
padding, so the message-passing layer calls them without a mask.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["gather", "segment_sum", "segment_mean", "segment_max",
           "segment_min", "segment_prod", "segment_reduce", "AGGREGATIONS"]


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


def segment_sum(data, segment_ids, num_segments, *, mask=None):
    """Masked segment sum; empty segments get 0."""
    data = _masked(data, mask, 0)
    return _out(data, num_segments, 0).index_add(0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments, *, mask=None):
    """Masked segment mean dividing by the true segment size; empty -> 0."""
    s = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = data.new_ones(data.shape[:1])
    cnt = segment_sum(ones, segment_ids, num_segments, mask=mask)
    cnt = cnt.clamp(min=1)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))


def _segment_extreme(op_min: bool, data, segment_ids, num_segments, *,
                     mask=None, empty_value=0.0):
    fill = float("inf") if op_min else float("-inf")
    data = _masked(data, mask, fill)
    idx = segment_ids.reshape(segment_ids.shape + (1,) * (data.dim() - 1))
    out = _out(data, num_segments, fill).scatter_reduce(
        0, idx.expand_as(data), data, "amin" if op_min else "amax",
        include_self=False)
    if empty_value is not None:
        # untouched or fully masked segments come back as +-inf
        out = torch.where(out == fill, torch.full_like(out, empty_value), out)
    return out


def segment_max(data, segment_ids, num_segments, *, mask=None,
                empty_value=0.0):
    return _segment_extreme(False, data, segment_ids, num_segments,
                            mask=mask, empty_value=empty_value)


def segment_min(data, segment_ids, num_segments, *, mask=None,
                empty_value=0.0):
    return _segment_extreme(True, data, segment_ids, num_segments,
                            mask=mask, empty_value=empty_value)


def segment_prod(data, segment_ids, num_segments, *, mask=None):
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


def segment_reduce(aggr, data, segment_ids, num_segments, *, mask=None):
    """Dispatch on ``aggr`` in {sum, mean, max, min, prod} (and aliases)."""
    if callable(aggr):
        aggr = getattr(aggr, "__name__", str(aggr))
    try:
        fn = AGGREGATIONS[str(aggr)]
    except KeyError:
        raise ValueError(f"unknown aggregation {aggr!r}; "
                         f"expected one of {list(AGGREGATIONS)}") from None
    return fn(data, segment_ids, num_segments, mask=mask)
