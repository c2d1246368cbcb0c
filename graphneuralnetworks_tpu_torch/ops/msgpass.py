"""Message passing: propagate / apply_edges / aggregate_neighbors.

Counterpart of ``graphneuralnetworks_tpu/ops/msgpass.py`` (reference
GNNlib msgpass.jl:69-238), with the same message vocabulary.

- ``apply_edges(f, g, xi, xj, e)`` gathers ``xi`` on receivers and ``xj``
  on senders and maps ``f(xi, xj, e)`` over the edges. Node arrays gather
  through :func:`~.cuda.fast_gather`, whose backward is the K1 kernel.
- ``aggregate_neighbors(g, aggr, m)`` reduces edge messages onto receivers.
- ``propagate(f, g, aggr, ...)`` composes the two, except that a sum (or
  mean) of ``copy_xj`` / ``w_mul_xj`` / ``e_mul_xj`` messages with scalar
  edge weights is one SpMM (:func:`~.cuda.spmm`); mean is that sum divided
  by the true in-degree, at every graph size.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..graph import GraphTuple
from .cuda.gather import fast_gather
from .cuda.spmm import spmm
from .segment import gather, segment_reduce

__all__ = ["apply_edges", "aggregate_neighbors", "propagate", "copy_xi",
           "copy_xj", "xi_dot_xj", "xi_sub_xj", "xj_sub_xi", "e_mul_xj",
           "w_mul_xj"]

_SUM = ("sum", "add", "+")


def _map_leaves(fn, x):
    """Apply ``fn`` to a tensor or to each value of a dict."""
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


def apply_edges(f: Callable, g: GraphTuple, xi=None, xj=None, e=None):
    """Gather endpoint features and apply ``f`` over edges.

    ``xi``/``xj`` are node tensors ``[num_nodes, ...]`` (or dicts of them),
    ``e`` an edge tensor ``[num_edges, ...]`` (or dict); returns whatever
    ``f`` returns on edge-shaped inputs.
    """
    def take_r(v):
        if v.dim() == 2 and v.shape[0] == g.num_nodes:
            return fast_gather(v, g.receivers, g.indptr_r, None)
        return gather(v, g.receivers)

    def take_s(v):
        if v.dim() == 2 and v.shape[0] == g.num_nodes:
            return fast_gather(v, g.senders, g.indptr_s, g.eid_s)
        return gather(v, g.senders)

    return f(_map_leaves(take_r, xi), _map_leaves(take_s, xj), e)


def aggregate_neighbors(g: GraphTuple, aggr, m, *, num_segments=None):
    """Reduce edge messages onto receiving nodes; ``mean`` divides by the
    true in-degree and empty segments give 0."""
    n = num_segments if num_segments is not None else g.num_nodes
    return _map_leaves(lambda v: segment_reduce(aggr, v, g.receivers, n), m)


def _spmm_message(f, g, xj, e):
    """``sum_j f(., xj, e)`` as one SpMM, or None when ``f`` is not one."""
    if f is copy_xj:
        return spmm(g, xj)
    if f is w_mul_xj and e is None:
        return spmm(g, xj, weighted=True)
    if f in (w_mul_xj, e_mul_xj) and e is not None and e.dim() == 1:
        return spmm(g, xj, edge_weight=e)
    return None


def propagate(f: Callable, g: GraphTuple, aggr, *, xi=None, xj=None, e=None):
    """``aggregate_neighbors(g, aggr, apply_edges(f, g, xi, xj, e))``, with
    the SpMM fast path described in the module docstring."""
    if ((aggr in _SUM or aggr == "mean") and isinstance(xj, torch.Tensor)
            and xj.dim() == 2):
        y = _spmm_message(f, g, xj, e)
        if y is not None:
            if aggr == "mean":
                deg = torch.diff(g.indptr_r).to(y.dtype).clamp(min=1)
                y = y / deg[:, None]
            return y
    if f is w_mul_xj and e is None:
        # the fused path reads the graph's stored weights; so does this one
        e = g.edge_weight
    m = apply_edges(f, g, xi=xi, xj=xj, e=e)
    return aggregate_neighbors(g, aggr, m)


# ---- message vocabulary (GNNlib msgpass.jl:159-208) ------------------------

def copy_xj(xi, xj, e):
    """m = xj (the source feature)."""
    return xj


def copy_xi(xi, xj, e):
    """m = xi (the target feature)."""
    return xi


def xi_dot_xj(xi, xj, e):
    """Row-wise dot product over the feature axis -> ``[E, 1]``."""
    return (xi * xj).sum(-1, keepdim=True)


def xi_sub_xj(xi, xj, e):
    return xi - xj


def xj_sub_xi(xi, xj, e):
    return xj - xi


def e_mul_xj(xi, xj, e):
    """Edge features times source features, ``e`` broadcast on the right."""
    if e.dim() < xj.dim():
        e = e.reshape(e.shape + (1,) * (xj.dim() - e.dim()))
    return e * xj


def w_mul_xj(xi, xj, w):
    """Scalar edge weights times source features (None: unweighted)."""
    if w is None:
        return xj
    if w.dim() < xj.dim():
        w = w.reshape(w.shape + (1,) * (xj.dim() - w.dim()))
    return w * xj
