"""Message passing: propagate / apply_edges / aggregate_neighbors.

Counterpart of ``graphneuralnetworks_tpu/ops/msgpass.py`` (reference
GNNlib msgpass.jl:69-238), with the same message vocabulary.

- ``apply_edges(f, g, xi, xj, e)`` gathers ``xi`` on receivers and ``xj``
  on senders and maps ``f(xi, xj, e)`` over the edges. Node arrays gather
  through :func:`~.cuda.fast_gather`, whose backward is the K1 kernel. On
  the card, ``xi_dot_xj`` of two node matrices is one SDDMM (K13, whose
  backward is K1 twice) at every width.
- ``aggregate_neighbors(g, aggr, m)`` reduces edge messages onto receivers;
  on the card ``max`` and ``min`` are one K14 over the receiver CSR (its
  backward a kernel too), whatever the message width. K14 reads the
  messages in receiver-CSR order, so on the card it raises for a reversed
  graph (``GraphTuple.reverse``), whose edges are not in that order.
- ``propagate(f, g, aggr, ...)`` composes the two, except that a sum (or
  mean) of ``copy_xj`` / ``w_mul_xj`` / ``e_mul_xj`` messages with scalar
  edge weights is one SpMM (:func:`~.cuda.spmm`); mean is that sum divided
  by the in-degree, at every graph size, counted as the JAX package counts
  it: in ``y``'s dtype, so a bfloat16 count stops at 256
  (:func:`~.segment.count_as`).

On a graph with ``edge_valid`` (``DeviceSampler``'s) that SpMM route is the
one that honours it: an invalid edge weighs 0 and mean divides by the
count of valid in-edges. ``apply_edges`` and ``aggregate_neighbors`` raise
on such a graph (their messages and reductions would count every edge).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..graph import (GraphTuple, no_edge_valid,
                     receiver_positions_are_edge_ids)
from . import segment
from .cuda.edge_softmax import _rows
from .cuda.gather import fast_gather
from .cuda.sddmm import sddmm
from .cuda.spmm import spmm
from .segment import count_as, gather, is_extreme, segment_reduce

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


def _kernel_route(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _sddmm_message(f, g, xi, xj, e) -> bool:
    """Whether ``f(xi, xj, e)`` is one SDDMM on the card: ``xi_dot_xj`` of
    two ``[num_nodes, D]`` CUDA tensors and no edge features."""
    return (f is xi_dot_xj and e is None
            and all(isinstance(v, torch.Tensor) and v.dim() == 2
                    and v.shape[0] == g.num_nodes for v in (xi, xj))
            and _kernel_route(xj))


def apply_edges(f: Callable, g: GraphTuple, xi=None, xj=None, e=None):
    """Gather endpoint features and apply ``f`` over edges.

    ``xi``/``xj`` are node tensors ``[num_nodes, ...]`` (or dicts of them),
    ``e`` an edge tensor ``[num_edges, ...]`` (or dict); returns whatever
    ``f`` returns on edge-shaped inputs.
    """
    no_edge_valid(g, "apply_edges")
    if _sddmm_message(f, g, xi, xj, e):
        return sddmm(g, xi, xj)[:, None]

    def take_r(v):
        if v.dim() == 2 and v.shape[0] == g.num_nodes:
            return fast_gather(v, g.receivers, g.indptr_r, g.eid_r)
        return gather(v, g.receivers)

    def take_s(v):
        if v.dim() == 2 and v.shape[0] == g.num_nodes:
            return fast_gather(v, g.senders, g.indptr_s, g.eid_s)
        return gather(v, g.senders)

    return f(_map_leaves(take_r, xi), _map_leaves(take_s, xj), e)


def _receiver_csr(g: GraphTuple, n: int, v: torch.Tensor, route: str):
    """The receiver CSR with ``n`` rows that K14 takes for the edge rows
    ``v``: cut (every receiver must stay below ``n``) or extended by rows
    without edges. A reversed graph's edges are not in its order: None
    where ``v`` takes the plain reduction (which reads receiver ids), and
    ``route`` raises on the card."""
    if not g.sorted_by_receivers:
        if segment._kernel_route(v):
            receiver_positions_are_edge_ids(g, route)
        return None
    if n <= g.num_nodes:
        return _rows(g, n)
    return torch.cat([g.indptr_r, g.indptr_r[-1:].expand(n - g.num_nodes)])


def aggregate_neighbors(g: GraphTuple, aggr, m, *, num_segments=None):
    """Reduce edge messages onto receiving nodes; ``mean`` divides by the
    true in-degree and empty segments give 0."""
    no_edge_valid(g, f"aggregate_neighbors({aggr!r})")
    n = num_segments if num_segments is not None else g.num_nodes

    def reduce(v):
        indptr = (_receiver_csr(g, n, v, f"aggregate_neighbors({aggr!r}) "
                                "on the card (K14)")
                  if is_extreme(aggr) else None)
        return segment_reduce(aggr, v, g.receivers, n, indptr=indptr)

    return _map_leaves(reduce, m)


def _spmm_message(f, g, xj, e):
    """``sum_j f(., xj, e)`` as one SpMM, or None when ``f`` is not one."""
    if f is copy_xj:
        return spmm(g, xj)
    if f is w_mul_xj and e is None:
        return spmm(g, xj, weighted=True)
    if f in (w_mul_xj, e_mul_xj) and e is not None and e.dim() == 1:
        return spmm(g, xj, edge_weight=e)
    return None


def _in_degree(g: GraphTuple) -> torch.Tensor:
    """Each node's count of in-edges that count: ``diff(indptr_r)``, or with
    ``edge_valid`` the valid ones, as the difference of a running count of
    the validity in receiver-CSR order at each row's ends (no read back to
    the host, unlike a ``bincount``)."""
    if g.edge_valid is None:
        return torch.diff(g.indptr_r)
    v = g.edge_valid if g.eid_r is None else g.edge_valid[g.eid_r.long()]
    c = torch.cat([v.new_zeros(1, dtype=torch.int64), torch.cumsum(v, 0)])
    ip = g.indptr_r.long()
    return c[ip[1:]] - c[ip[:-1]]


def propagate(f: Callable, g: GraphTuple, aggr, *, xi=None, xj=None, e=None):
    """``aggregate_neighbors(g, aggr, apply_edges(f, g, xi, xj, e))``, with
    the SpMM fast path described in the module docstring."""
    if ((aggr in _SUM or aggr == "mean") and isinstance(xj, torch.Tensor)
            and xj.dim() == 2):
        y = _spmm_message(f, g, xj, e)
        if y is not None:
            if aggr == "mean":
                deg = count_as(_in_degree(g), y.dtype).clamp(min=1)
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
