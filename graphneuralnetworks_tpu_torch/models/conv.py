"""Convolution layers of the main path: GCN, GraphConv, GIN, SAGE, and MLP.

Counterpart of ``graphneuralnetworks_tpu/models/conv.py`` (surfaces from
GraphNeuralNetworks conv.jl, math from GNNlib conv.jl). Weights are stored
``[in, out]`` as in the JAX package, except inside :class:`MLP`, whose
``torch.nn.Linear`` layers store ``[out, in]``. As there, GCN's
``add_self_loops`` adds no edges: the self term is folded into the degree
and added as ``c_i * x_i``.

Constructors take ``generator`` (a ``torch.Generator`` for the Glorot
init), ``device`` (``None``: the CUDA card) and ``dtype``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphTuple
from ..ops import copy_xj, e_mul_xj, propagate, w_mul_xj
from ..ops.segment import segment_sum
from ..query import degree
from .basic import GNNLayer, glorot_uniform

__all__ = ["GCNConv", "GraphConv", "GINConv", "SAGEConv", "MLP"]


def _weight(shape, generator, device, dtype) -> nn.Parameter:
    return nn.Parameter(glorot_uniform(shape, generator=generator,
                                       dtype=dtype, device=device))


def _bias(n, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


def _expand_srcdst(x):
    """``x`` or a bipartite ``(x_src, x_dst)`` -> ``(xj, xi)``."""
    if isinstance(x, (tuple, list)):
        xsrc, xdst = x
        return xsrc, xdst
    return x, x


def _inv_sqrt(d):
    return torch.where(d > 0, torch.rsqrt(d.clamp(min=1e-12)),
                       torch.zeros_like(d))


class MLP(nn.Module):
    """A chain of Dense layers, used as the ``nn`` argument of GINConv."""

    def __init__(self, dims, act=torch.relu, *, final_act=None,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.linears = nn.ModuleList()
        for a, b in zip(dims[:-1], dims[1:]):
            lin = nn.utils.skip_init(nn.Linear, a, b, bias=use_bias,
                                     device=device, dtype=dtype)
            with torch.no_grad():
                lin.weight.copy_(glorot_uniform((b, a), generator=generator,
                                                dtype=dtype, device=device))
                if use_bias:
                    lin.bias.zero_()
            self.linears.append(lin)
        self.act = act
        self.final_act = final_act

    def forward(self, x):
        n = len(self.linears)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < n - 1:
                x = self.act(x)
            elif self.final_act is not None:
                x = self.final_act(x)
        return x


# ---- GCN -------------------------------------------------------------------

def _gcn_norm(g: GraphTuple, *, edge_weight, use_edge_weight, add_self_loops,
              norm_fn, dtype):
    """``c = norm_fn(in-degree [+ 1 for the virtual self-loop])``."""
    if edge_weight is not None:
        d = degree(g, dir="in", edge_weight=edge_weight, dtype=dtype)
    elif use_edge_weight and g.edge_weight is not None:
        d = degree(g, dir="in", dtype=dtype)
    else:
        d = degree(g, dir="in", edge_weight=False, dtype=dtype)
    if add_self_loops:
        d = d + 1.0
    return norm_fn(d) if norm_fn is not None else _inv_sqrt(d)


def _gcn_propagate(g: GraphTuple, x, c, *, edge_weight, use_edge_weight,
                   add_self_loops):
    """``c * (A^T (c * x))`` plus the virtual self-loop's ``c * c * x``."""
    xj = x * c[:, None]
    if edge_weight is not None:
        agg = propagate(e_mul_xj, g, "sum", xj=xj, e=edge_weight)
    elif use_edge_weight and g.edge_weight is not None:
        agg = propagate(w_mul_xj, g, "sum", xj=xj, e=g.edge_weight)
    else:
        agg = propagate(copy_xj, g, "sum", xj=xj)
    if add_self_loops:
        agg = agg + xj
    return agg * c[:, None]


class GCNConv(GNNLayer):
    """Graph convolution (Kipf & Welling): ``act(W (D^-1/2 A D^-1/2 x) + b)``.

    Optional edge weights, and forward-time ``norm_fn``/``conv_weight``
    overrides. ``W`` multiplies on the cheaper side: before propagation when
    ``out < in``, after it otherwise (reference conv.jl:36-40).
    """

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, add_self_loops: bool = True,
                 use_edge_weight: bool = False, use_bias: bool = True,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((in_features, out_features), generator, device,
                              dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.act = act
        self.add_self_loops = add_self_loops
        self.use_edge_weight = use_edge_weight
        self.in_features, self.out_features = in_features, out_features

    def forward(self, g: GraphTuple, x=None, edge_weight=None, *,
                norm_fn=None, conv_weight=None):
        if x is None:
            x = g.x
        W = self.weight if conv_weight is None else conv_weight
        din, dout = W.shape
        if isinstance(x, (tuple, list)):
            return self._bipartite(g, x, W, norm_fn, edge_weight)
        if dout < din:
            x = x @ W
        c = _gcn_norm(g, edge_weight=edge_weight,
                      use_edge_weight=self.use_edge_weight,
                      add_self_loops=self.add_self_loops, norm_fn=norm_fn,
                      dtype=x.dtype)
        x = _gcn_propagate(g, x, c, edge_weight=edge_weight,
                           use_edge_weight=self.use_edge_weight,
                           add_self_loops=self.add_self_loops)
        if dout >= din:
            x = x @ W
        if self.bias is not None:
            x = x + self.bias
        return self.act(x) if self.act is not None else x

    def _bipartite(self, g: GraphTuple, x, W, norm_fn, edge_weight=None):
        """Separate unweighted out/in-degree norms for source and target
        node sets, ``W`` after propagation, no self-loop (GNNlib
        conv.jl:45-70)."""
        xj, xi = _expand_srcdst(x)
        ones = xj.new_ones(g.num_edges)
        cout = segment_sum(ones, g.senders, xj.shape[0])
        cin = segment_sum(ones, g.receivers, xi.shape[0])
        nf = norm_fn if norm_fn is not None else _inv_sqrt
        xjc = xj * nf(cout)[:, None]
        if edge_weight is not None:
            m = propagate(e_mul_xj, g, "sum", xj=xjc, e=edge_weight)
        elif self.use_edge_weight and g.edge_weight is not None:
            m = propagate(w_mul_xj, g, "sum", xj=xjc, e=g.edge_weight)
        else:
            m = propagate(copy_xj, g, "sum", xj=xjc)
        m = m[: xi.shape[0]] * nf(cin)[:, None]
        out = m @ W
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class GraphConv(GNNLayer):
    """``act(W1 x_i + W2 aggr_j x_j + b)`` (reference conv.jl:226-254)."""

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, aggr="sum",
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight1 = _weight((in_features, out_features), generator, device,
                               dtype)
        self.weight2 = _weight((in_features, out_features), generator, device,
                               dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.act = act
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)
        m = propagate(copy_xj, g, self.aggr, xj=xj)[: xi.shape[0]]
        out = xi @ self.weight1 + m @ self.weight2
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class GINConv(GNNLayer):
    """Graph isomorphism network: ``nn((1 + eps) x_i + aggr_j x_j)``
    (reference conv.jl:628-645). ``eps`` is fixed; only ``nn`` trains."""

    def __init__(self, nn_module: nn.Module, eps: float = 0.0, *,
                 aggr="sum"):
        super().__init__()
        self.nn = nn_module
        self.eps = eps
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)
        m = propagate(copy_xj, g, self.aggr, xj=xj)[: xi.shape[0]]
        return self.nn((1.0 + self.eps) * xi + m)


class SAGEConv(GNNLayer):
    """GraphSAGE: ``act(W [x_i ; aggr_j x_j] + b)``, mean by default
    (reference conv.jl:770-795)."""

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, aggr="mean",
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((2 * in_features, out_features), generator,
                              device, dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.act = act
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)
        m = propagate(copy_xj, g, self.aggr, xj=xj)[: xi.shape[0]]
        out = torch.cat([xi, m], -1) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out
