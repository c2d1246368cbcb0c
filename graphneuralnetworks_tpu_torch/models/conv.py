"""Convolution layers: GCN, GraphConv, GIN, SAGE, EdgeConv, MLP, the
edge-featured NNConv, CGConv, MEGNet, GMM and EGNN, GAT, GATv2, AGNN,
Transformer, ResGatedGraph, GatedGraph, and the propagation family Cheb,
SG, TAG and DConv.

Counterpart of ``graphneuralnetworks_tpu/models/conv.py`` (surfaces from
GraphNeuralNetworks conv.jl, math from GNNlib conv.jl). Weights are stored
``[in, out]`` as in the JAX package, except inside :class:`MLP`, whose
``torch.nn.Linear`` layers store ``[out, in]``. As there, GCN's
``add_self_loops`` adds no edges: the self term is folded into the degree
and added as ``c_i * x_i``.

Constructors take ``generator`` (a ``torch.Generator`` for the Glorot
init), ``device`` (``None``: the CUDA card) and ``dtype``. The attention
layers' self-loops are virtual too (:mod:`..ops.attention`). The
propagation family runs every hop as one SpMM (K1) through ``propagate``;
``DConv`` also over ``g.reverse()``, whose forward reads the edge weights
through the reversed graph's edge-id map. The edge-featured layers compute
their messages on the edges from endpoint gathers (``fast_gather``, whose
backward is K1) and reduce them with the segment ops, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphTuple
from ..ops import (aggregate_neighbors, apply_edges, copy_xj, e_mul_xj,
                   propagate, to_src_space, w_mul_xj, xi_sub_xj)
from ..ops.attention import (attention_aggregate, dot_attention,
                             gat_attention, gatv2_attention)
from ..ops.cuda.edge_softmax import lrelu
from ..ops.segment import gather, segment_sum
from ..query import degree, jax_n_pad, power_eigmax, scaled_laplacian
from .basic import GNNLayer, glorot_uniform

__all__ = ["GCNConv", "GraphConv", "GINConv", "SAGEConv", "EdgeConv", "MLP",
           "GATConv", "GATv2Conv", "AGNNConv", "TransformerConv",
           "BatchNorm", "ResGatedGraphConv", "GatedGraphConv", "GRUCell",
           "ChebConv", "cheb_lambda_max", "SGConv", "TAGConv", "DConv",
           "NNConv", "CGConv", "MEGNetConv", "GMMConv", "EGNNConv"]

# ChebConv takes the matrix-free path where the JAX package's default padded
# node count round_up(N + 1, 8) exceeds 2048 (its ``g.n_pad > 2048``,
# conv.py:294): from N = 2048 nodes on
_CHEB_DENSE_MAX_N_PAD = 2048


def _weight(shape, generator, device, dtype) -> nn.Parameter:
    return nn.Parameter(glorot_uniform(shape, generator=generator,
                                       dtype=dtype, device=device))


def _bias(n, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


def _dense(fan_in, fan_out, use_bias, generator, device,
           dtype) -> nn.Linear:
    """``nn.Linear`` with a Glorot weight (``[out, in]``) and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=use_bias,
                             device=device, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(glorot_uniform((fan_out, fan_in),
                                        generator=generator, dtype=dtype,
                                        device=device))
        if use_bias:
            lin.bias.zero_()
    return lin


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
        self.linears = nn.ModuleList(
            _dense(a, b, use_bias, generator, device, dtype)
            for a, b in zip(dims[:-1], dims[1:]))
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
        cout = segment_sum(ones, g.senders, xj.shape[0], mask=g.edge_valid)
        cin = segment_sum(ones, g.receivers, xi.shape[0], mask=g.edge_valid)
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


class EdgeConv(GNNLayer):
    """Dynamic edge conv (Wang et al., DGCNN; reference conv.jl:575-590,
    GNNlib conv.jl:237-246): ``aggr_j nn([x_i; x_j - x_i])``, max by
    default. The ``[E, 2 in]`` messages go through ``nn`` on the edges; on
    the card a max or min aggregation is one K14 over the receiver CSR,
    and the endpoint gathers' backward is K1."""

    def __init__(self, nn_module: nn.Module, *, aggr="max"):
        super().__init__()
        self.nn = nn_module
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)

        def msg(xi_e, xj_e, e):
            return self.nn(torch.cat([xi_e, xj_e - xi_e], -1))

        m = apply_edges(msg, g, xi=xi, xj=xj)
        return aggregate_neighbors(g, self.aggr, m, num_segments=xi.shape[0])


# ---- edge-featured layers: NNConv, CGConv, MEGNet, GMM, EGNN ---------------

class NNConv(GNNLayer):
    """Edge-conditioned conv (Gilmer et al., MPNN; reference conv.jl:701-730,
    GNNlib conv.jl:260-273): ``act(x W + aggr_j x_j reshape(nn(e), [in,
    out]) + b)``. ``nn`` maps each edge's features to an ``[in, out]``
    matrix, so the edges hold ``E * in * out`` values (and their gradient
    as many again). Parameters ``weight [in, out]``, ``bias`` and ``nn``."""

    def __init__(self, in_features: int, out_features: int,
                 nn_module: nn.Module, act: Callable | None = None, *,
                 aggr="sum", use_bias: bool = True, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((in_features, out_features), generator, device,
                              dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.nn = nn_module
        self.act = act
        self.aggr = aggr
        self.in_features, self.out_features = in_features, out_features

    def forward(self, g: GraphTuple, x=None, e=None):
        if x is None:
            x = g.x
        if e is None:
            e = g.e

        def msg(xi_e, xj_e, ee):
            W = self.nn(ee).reshape(-1, self.in_features, self.out_features)
            return torch.einsum("ei,eio->eo", xj_e, W)

        out = x @ self.weight + propagate(msg, g, self.aggr, xj=x, e=e)
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class CGConv(GNNLayer):
    """Crystal graph conv (Xie & Grossman; reference conv.jl:914-943, GNNlib
    conv.jl:304-333): ``sum_j sigmoid(dense_f(z)) * act(dense_s(z))`` with
    ``z = [x_i; x_j; e]`` (``e`` optional), plus ``x_i`` when ``residual``
    and the widths match. Takes ``(x_src, x_dst)``. ``dense_f`` and
    ``dense_s`` are ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, edge_features: int = 0,
                 residual: bool = False, use_bias: bool = True,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        zdim = 2 * in_features + edge_features
        self.dense_f = _dense(zdim, out_features, use_bias, generator, device,
                              dtype)
        self.dense_s = _dense(zdim, out_features, use_bias, generator, device,
                              dtype)
        self.act = act
        self.residual = residual

    def forward(self, g: GraphTuple, x=None, e=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)

        def msg(xi_e, xj_e, ee):
            z = torch.cat([xi_e, xj_e] + ([ee] if ee is not None else []), -1)
            s = self.dense_s(z)
            if self.act is not None:
                s = self.act(s)
            return torch.sigmoid(self.dense_f(z)) * s

        m = propagate(msg, g, "sum", xi=xi, xj=xj, e=e)[: xi.shape[0]]
        if self.residual and xi.shape[-1] == m.shape[-1]:
            m = m + xi
        return m


class MEGNetConv(GNNLayer):
    """MEGNet conv (Chen et al.; reference conv.jl:1035-1061, GNNlib
    conv.jl:356-368), returning ``(x_bar, e_bar)``: ``e_bar = phi_e([x_i;
    x_j; e])`` per edge, ``x_bar = phi_v([x; aggr_j e_bar])``. The default
    ``phi_e`` and ``phi_v`` are ``MLP([3 in, out, out])`` and ``MLP([in +
    out, out, out])`` with relu."""

    def __init__(self, in_features: int | None = None,
                 out_features: int | None = None, *, phi_e=None, phi_v=None,
                 aggr="mean", generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        if phi_e is None:
            phi_e = MLP([3 * in_features, out_features, out_features],
                        torch.relu, **kw)
        if phi_v is None:
            phi_v = MLP([in_features + out_features, out_features,
                         out_features], torch.relu, **kw)
        self.phi_e, self.phi_v = phi_e, phi_v
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None, e=None):
        if x is None:
            x = g.x
        if e is None:
            e = g.e

        def msg(xi_e, xj_e, ee):
            return self.phi_e(torch.cat([xi_e, xj_e, ee], -1))

        ebar = apply_edges(msg, g, xi=x, xj=x, e=e)
        xe = aggregate_neighbors(g, self.aggr, ebar)
        return self.phi_v(torch.cat([x, xe], -1)), ebar


class GMMConv(GNNLayer):
    """Gaussian mixture model conv (Monti et al., MoNet; reference
    conv.jl:1111-1148, GNNlib conv.jl:372-401): per edge ``K`` Gaussian
    weights ``w_k(e) = exp(-1/2 sum_d ((e_d - mu_kd) sigma_inv_kd)^2)``, the
    mean over in-edges of ``w_k * (dense_x x_j)_k``, then the mean over the
    ``K`` kernels, ``+ bias``, ``act`` and ``+ x`` when ``residual`` and the
    widths match. ``reference_exact=True`` takes the reference's ``exp(+1/2
    ...)``, as the JAX package's option does (conv.py:922-971). The ``[N, K
    * out]`` projection is gathered whole (its backward K1) and split into
    the ``K`` kernels on the edges. Parameters ``mu``, ``sigma_inv`` (``[K,
    edge_features]``), ``bias`` and ``dense_x`` (``nn.Linear``)."""

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, edge_features: int = 1,
                 K: int = 1, residual: bool = False, use_bias: bool = True,
                 reference_exact: bool = False, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.mu = _weight((K, edge_features), generator, device, dtype)
        self.sigma_inv = _weight((K, edge_features), generator, device, dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.dense_x = _dense(in_features, out_features * K, False, generator,
                              device, dtype)
        self.act = act
        self.K = K
        self.residual = residual
        self.reference_exact = reference_exact
        self.out_features = out_features

    def forward(self, g: GraphTuple, x=None, e=None):
        if x is None:
            x = g.x
        if e is None:
            e = g.e
        K, O = self.K, self.out_features
        sign = 0.5 if self.reference_exact else -0.5
        w = torch.exp(sign * (((e[:, None, :] - self.mu)
                               * self.sigma_inv) ** 2).sum(-1))   # [E, K]

        def msg(xi_e, xj_e, we):
            return we[:, :, None] * xj_e.reshape(-1, K, O)

        m = propagate(msg, g, "mean", xj=self.dense_x(x), e=w).mean(1)
        if self.bias is not None:
            m = m + self.bias
        if self.act is not None:
            m = self.act(m)
        if self.residual and x.shape[-1] == m.shape[-1]:
            m = m + x
        return m


class EGNNConv(GNNLayer):
    """E(n)-equivariant conv (Satorras et al.; reference conv.jl:1349-1399,
    GNNlib conv.jl:459-495), returning ``(h', x')``. Per edge ``m_h =
    phi_e([h_i; h_j; |x_i - x_j|^2; e])`` and ``m_x = phi_x(m_h) (x_i -
    x_j) / (|x_i - x_j| + 1e-6)``; ``h' = phi_h([h; sum_j m_h])`` (``+ h``
    when ``residual``, which needs ``in == out``), ``x' = x + mean_j m_x``.
    By default ``h`` is ``g.nodes["h"]`` and ``x`` is ``g.x``. Parameters
    ``phi_e``, ``phi_h`` (:class:`MLP`, swish), ``phi_x_hidden`` and
    ``phi_x_out`` (``nn.Linear``, the last without bias)."""

    def __init__(self, in_features: int, out_features: int, *,
                 edge_features: int = 0, hidden_size: int | None = None,
                 residual: bool = False, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if residual and in_features != out_features:
            raise ValueError("residual requires in == out")
        device = resolve_device(device)
        hid = hidden_size if hidden_size is not None else 2 * in_features
        act = nn.functional.silu
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.phi_e = MLP([2 * in_features + edge_features + 1, hid, hid], act,
                         final_act=act, **kw)
        self.phi_h = MLP([in_features + hid, hid, out_features], act, **kw)
        self.phi_x_hidden = _dense(hid, hid, True, generator, device, dtype)
        self.phi_x_out = _dense(hid, 1, False, generator, device, dtype)
        self.residual = residual

    def forward(self, g: GraphTuple, h=None, x=None, e=None):
        if h is None:
            h = g.nodes["h"]
        if x is None:
            x = g.x
        x_diff = apply_edges(xi_sub_xj, g, xi=x, xj=x)
        sqnorm = (x_diff ** 2).sum(-1, keepdim=True)
        x_diff = x_diff / (torch.sqrt(sqnorm) + 1e-6)

        def msg(xi_e, xj_e, ee):
            parts = [xi_e["h"], xj_e["h"], ee["sqnorm"]]
            if ee["e"] is not None:
                parts.append(ee["e"])
            mh = self.phi_e(torch.cat(parts, -1))
            mx = self.phi_x_out(nn.functional.silu(self.phi_x_hidden(mh)))
            return {"h": mh, "x": mx * ee["x_diff"]}

        m = apply_edges(msg, g, xi={"h": h}, xj={"h": h},
                        e={"e": e, "x_diff": x_diff, "sqnorm": sqnorm})
        hnew = self.phi_h(torch.cat([h, aggregate_neighbors(g, "sum",
                                                            m["h"])], -1))
        h = h + hnew if self.residual else hnew
        return h, x + aggregate_neighbors(g, "mean", m["x"])


# ---- attention family ------------------------------------------------------

def _attn_dropout_masks(p, gen, n_edges, n_dst, heads, with_self, device,
                        dtype):
    """Multiplicative dropout masks (0 or 1/(1-p)) for the attention
    weights of the edges and, ``with_self``, of the virtual self-loops."""
    def draw(rows):
        keep = torch.rand((rows, heads), generator=gen, device=device) < 1 - p
        return keep.to(dtype) / (1 - p)
    return draw(n_edges), (draw(n_dst) if with_self else None)


def _dropout_generator(p, generator, device):
    """The layer's own generator for its dropout masks, on its device,
    seeded from ``generator`` (``None`` when ``p == 0``)."""
    if p <= 0:
        return None
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


class GATConv(GNNLayer):
    """Graph attention (Velickovic et al.; reference conv.jl:309-411, GNNlib
    conv.jl:112-167).

    The score ``leaky_relu(a' [W x_i; W x_j; W_e e])`` is linear in the
    endpoints, so ``a`` is contracted at node level and only the per-head
    scalars ``pi``/``pj`` meet on the edges. Parameters keep the JAX
    package's names: ``dense_x`` and ``dense_e`` (``nn.Linear`` without
    bias), ``a [k*out, heads]`` and ``bias``. With ``dropout > 0`` and
    ``deterministic=False`` the attention weights are dropped with masks
    drawn from a generator the layer holds, seeded from ``generator``.
    """

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 add_self_loops: bool = True, dropout: float = 0.0,
                 use_bias: bool = True, edge_features: int = 0,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if add_self_loops and edge_features > 0:
            raise ValueError("edge features + add_self_loops unsupported "
                             "(reference conv.jl:332)")
        device = resolve_device(device)
        self.dense_x = _dense(in_features, out_features * heads, False,
                              generator, device, dtype)
        self.dense_e = (_dense(edge_features, out_features * heads, False,
                               generator, device, dtype)
                        if edge_features > 0 else None)
        k = 3 if edge_features > 0 else 2
        self.a = _weight((k * out_features, heads), generator, device, dtype)
        self.bias = (_bias(out_features * heads if concat else out_features,
                           device, dtype) if use_bias else None)
        self.dropout = dropout
        self._gen = _dropout_generator(dropout, generator, device)
        self.act = act
        self.heads, self.concat = heads, concat
        self.negative_slope = negative_slope
        self.add_self_loops = add_self_loops
        self.out_features = out_features

    def forward(self, g: GraphTuple, x=None, e=None, *,
                deterministic: bool = True):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)
        H, O, slope = self.heads, self.out_features, self.negative_slope
        Wxj = self.dense_x(xj).reshape(-1, H, O)
        Wxi = Wxj if xi is xj else self.dense_x(xi).reshape(-1, H, O)
        a = self.a
        pi = torch.einsum("nhf,fh->nh", Wxi, a[:O])          # [N_dst, H]
        pj = torch.einsum("nhf,fh->nh", Wxj, a[O:2 * O])     # [N_src, H]
        self_logits = self_values = None
        if self.add_self_loops:
            pj_self = (pi + pj if xi is xj
                       else pi + torch.einsum("nhf,fh->nh", Wxi, a[O:2 * O]))
            self_logits, self_values = lrelu(pj_self, slope), Wxi
        masks = None
        if self.dropout > 0 and not deterministic:
            masks = _attn_dropout_masks(
                self.dropout, self._gen, g.num_edges,
                Wxi.shape[0], H, self.add_self_loops, Wxi.device, Wxi.dtype)
        if e is None and self.dense_e is None:
            out = gat_attention(g, pi, pj, Wxj, slope,
                                self_logits=self_logits,
                                self_values=self_values, dropout_masks=masks,
                                num_segments=Wxi.shape[0],
                                pj_weight=a[O:2 * O])
        else:
            if e is None or self.dense_e is None:
                raise ValueError("edge features required/not configured")
            We = self.dense_e(e).reshape(-1, H, O)
            raw = (gather(pi, g.receivers)
                   + gather(to_src_space(g, pj), g.senders)
                   + torch.einsum("ehf,fh->eh", We, a[2 * O:]))
            out = attention_aggregate(g, lrelu(raw, slope), Wxj,
                                      self_logits=self_logits,
                                      self_values=self_values,
                                      dropout_masks=masks,
                                      num_segments=Wxi.shape[0],
                                      node_values=True)
        out = out.reshape(-1, H * O) if self.concat else out.mean(1)
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class GATv2Conv(GNNLayer):
    """GATv2 (Brody et al., "How Attentive are GATs?"; reference
    conv.jl:413-512, GNNlib conv.jl:171-214).

    The score ``a' leaky_relu(W_i x_i + W_j x_j [+ W_e e])`` puts the
    leaky_relu before the ``a`` contraction, so it is taken per edge over
    whole ``[H, O]`` rows, inside the kernels on the card
    (:func:`~..ops.attention.gatv2_attention`); the values are ``W_j x_j``.
    Parameters keep the JAX package's names: ``dense_i`` (``nn.Linear``,
    with bias when ``use_bias``), ``dense_j`` and ``dense_e`` (no bias),
    ``a [out, heads]`` and ``bias``. Dropout as in :class:`GATConv`.
    """

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 add_self_loops: bool = True, dropout: float = 0.0,
                 use_bias: bool = True, edge_features: int = 0,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if add_self_loops and edge_features > 0:
            raise ValueError("edge features + add_self_loops unsupported")
        device = resolve_device(device)

        def dense(fan_in, bias):
            return _dense(fan_in, out_features * heads, bias, generator,
                          device, dtype)

        self.dense_i = dense(in_features, use_bias)
        self.dense_j = dense(in_features, False)
        self.dense_e = (dense(edge_features, False) if edge_features > 0
                        else None)
        self.a = _weight((out_features, heads), generator, device, dtype)
        self.bias = (_bias(out_features * heads if concat else out_features,
                           device, dtype) if use_bias else None)
        self.dropout = dropout
        self._gen = _dropout_generator(dropout, generator, device)
        self.act = act
        self.heads, self.concat = heads, concat
        self.negative_slope = negative_slope
        self.add_self_loops = add_self_loops
        self.out_features = out_features

    def _logits(self, wx):
        return torch.einsum("...hf,fh->...h",
                            lrelu(wx, self.negative_slope), self.a)

    def forward(self, g: GraphTuple, x=None, e=None, *,
                deterministic: bool = True):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)
        H, O = self.heads, self.out_features
        Wxi = self.dense_i(xi).reshape(-1, H, O)
        Wxj = self.dense_j(xj).reshape(-1, H, O)
        self_logits = self_values = None
        if self.add_self_loops:
            # the self edge: dense_i(x_i) + dense_j(x_i)
            Wji = Wxj if xi is xj else self.dense_j(xi).reshape(-1, H, O)
            self_logits, self_values = self._logits(Wxi + Wji), Wji
        masks = None
        if self.dropout > 0 and not deterministic:
            masks = _attn_dropout_masks(
                self.dropout, self._gen, g.num_edges,
                Wxi.shape[0], H, self.add_self_loops, Wxi.device, Wxi.dtype)
        if e is None and self.dense_e is None:
            out = gatv2_attention(g, Wxi, Wxj, self.a, self.negative_slope,
                                  self_logits=self_logits,
                                  self_values=self_values,
                                  dropout_masks=masks,
                                  num_segments=Wxi.shape[0])
        else:
            if e is None or self.dense_e is None:
                raise ValueError("edge features required/not configured")
            wx = (gather(Wxi, g.receivers)
                  + gather(to_src_space(g, Wxj), g.senders)
                  + self.dense_e(e).reshape(-1, H, O))
            out = attention_aggregate(g, self._logits(wx), Wxj,
                                      self_logits=self_logits,
                                      self_values=self_values,
                                      dropout_masks=masks,
                                      num_segments=Wxi.shape[0],
                                      node_values=True)
        out = out.reshape(-1, H * O) if self.concat else out.mean(1)
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class AGNNConv(GNNLayer):
    """Attention-based GNN (Thekumparampil et al.; reference
    conv.jl:988-1002, GNNlib conv.jl:337-352): cosine-similarity attention
    with a temperature ``beta``, over in-edges and a virtual self-loop.

    ``beta`` (shape ``(1,)``) is a parameter, or a buffer when
    ``trainable=False``. It folds into the query, so the logits
    ``beta <x_i/|x_i|, x_j/|x_j|>`` are computed inside the dot-attention
    kernels on the card (:func:`~..ops.attention.dot_attention`).
    """

    def __init__(self, *, init_beta: float = 1.0, add_self_loops: bool = True,
                 trainable: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        beta = torch.full((1,), init_beta, dtype=dtype,
                          device=resolve_device(device))
        if trainable:
            self.beta = nn.Parameter(beta)
        else:
            self.register_buffer("beta", beta)
        self.add_self_loops = add_self_loops

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        beta = self.beta[0]
        norm = torch.sqrt((x * x).sum(-1, keepdim=True).clamp(min=1e-24))
        xn = x / norm
        self_logits = self_values = None
        if self.add_self_loops:
            self_logits = (beta * (xn * xn).sum(-1))[:, None]     # [N, 1]
            self_values = x[:, None, :]
        return dot_attention(g, (beta * xn)[:, None, :], xn[:, None, :],
                             x[:, None, :], 1.0, self_logits=self_logits,
                             self_values=self_values)[:, 0, :]


class BatchNorm(nn.BatchNorm1d):
    """``nnx.BatchNorm`` over ``[N, C]``: momentum 0.99 of the running
    average (torch's ``momentum=0.01``), eps 1e-5, and the BIASED batch
    variance ``max(E[x^2] - E[x]^2, 0)`` both to normalise and to update the
    running variance (``torch.nn.BatchNorm1d`` updates it with the unbiased
    one). ``use_running_average`` chooses the running statistics (JAX's
    ``deterministic``), not ``self.training``. Parameters ``weight`` and
    ``bias`` are nnx's ``scale`` and ``bias``, buffers ``running_mean`` and
    ``running_var`` its ``mean`` and ``var``.
    """

    decay = 0.99    # nnx's momentum

    def __init__(self, num_features: int, *, device=None,
                 dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1 - self.decay,
                         device=resolve_device(device), dtype=dtype)

    def forward(self, x, use_running_average: bool = True):
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(0)
            var = ((x * x).mean(0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                for stat, new in ((self.running_mean, mean),
                                  (self.running_var, var)):
                    stat.copy_(self.decay * stat + (1 - self.decay) * new)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class TransformerConv(GNNLayer):
    """UniMP transformer conv (Shi et al.; reference conv.jl:1473-1547, GNNlib
    conv.jl:553-629): scaled dot-product attention over in-edges, with an
    optional root weight ``W1``, gating ``W5``, edge features ``W6``, a
    virtual self-loop, skip connection, batch norms and a feed-forward
    block.

    Without edge features the logits ``<W3 x_i, W4 x_j> / sqrt(out)`` are
    computed inside the dot-attention kernels on the card, summing the
    values ``W2 x_j``; with edge features ``e`` the keys and values shift
    per edge and the logits are gathered, then :func:`attention_aggregate`
    (edge values) takes over. Parameters keep the JAX package's names:
    ``W1``-``W6`` (``nn.Linear``), ``FF`` (:class:`MLP`), ``BN1``, ``BN2``
    (:class:`BatchNorm`, applied with the running statistics when
    ``deterministic``).
    """

    def __init__(self, in_features: int, out_features: int, *,
                 heads: int = 1, concat: bool = True,
                 add_self_loops: bool = False, bias_qkv: bool = True,
                 bias_root: bool = True, root_weight: bool = True,
                 gating: bool = False, skip_connection: bool = False,
                 batch_norm: bool = False, ff_channels: int = 0,
                 edge_features: int = 0, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if add_self_loops and edge_features > 0:
            raise ValueError("edge features + add_self_loops unsupported")
        device = resolve_device(device)
        O, H = out_features, heads
        out_mha = O * (H if concat else 1)

        def mk(fan_in, fan_out, bias):
            return _dense(fan_in, fan_out, bias, generator, device, dtype)

        self.W1 = mk(in_features, out_mha, bias_root) if root_weight else None
        self.W2 = mk(in_features, O * H, bias_qkv)
        self.W3 = mk(in_features, O * H, bias_qkv)
        self.W4 = mk(in_features, O * H, bias_qkv)
        self.W5 = mk(3 * out_mha, 1, False) if gating else None
        self.W6 = (mk(edge_features, O * H, bias_qkv) if edge_features > 0
                   else None)
        self.FF = (MLP([out_mha, ff_channels, out_mha], torch.relu,
                       generator=generator, device=device, dtype=dtype)
                   if ff_channels > 0 else None)
        bn = functools.partial(BatchNorm, out_mha, device=device, dtype=dtype)
        self.BN1 = bn() if batch_norm else None
        self.BN2 = bn() if batch_norm and ff_channels > 0 else None
        self.heads, self.concat = H, concat
        self.out_features = O
        self.add_self_loops = add_self_loops
        self.skip_connection = skip_connection
        self.sqrt_out = math.sqrt(O)

    def forward(self, g: GraphTuple, x=None, e=None, *,
                deterministic: bool = True):
        if x is None:
            x = g.x
        H, O = self.heads, self.out_features
        W1x = self.W1(x) if self.W1 is not None else None
        W2x = self.W2(x).reshape(-1, H, O)
        W3x = self.W3(x).reshape(-1, H, O)
        W4x = self.W4(x).reshape(-1, H, O)
        self_logits = self_values = None
        if self.add_self_loops:
            self_logits = (W3x * W4x).sum(-1) / self.sqrt_out
            self_values = W2x
        if e is not None:
            if self.W6 is None:
                raise ValueError("edge features not configured")
            W6e = self.W6(e).reshape(-1, H, O)
            key = gather(to_src_space(g, W4x), g.senders) + W6e
            val = gather(to_src_space(g, W2x), g.senders) + W6e
            logits = (gather(W3x, g.receivers) * key).sum(-1) / self.sqrt_out
            h = attention_aggregate(g, logits, val, self_logits=self_logits,
                                    self_values=self_values)
        else:
            h = dot_attention(g, W3x, W4x, W2x, 1.0 / self.sqrt_out,
                              self_logits=self_logits,
                              self_values=self_values)
        h = h.reshape(-1, H * O) if self.concat else h.mean(1)
        if W1x is not None:
            if self.W5 is not None:
                beta = torch.sigmoid(self.W5(torch.cat([h, W1x, h - W1x],
                                                       -1)))
                h = beta * W1x + (1.0 - beta) * h
            else:
                h = h + W1x
        if self.skip_connection:
            h = h + x
        if self.BN1 is not None:
            h = self.BN1(h, use_running_average=deterministic)
        if self.FF is not None:
            h1 = h
            h = self.FF(h)
            if self.skip_connection:
                h = h + h1
            if self.BN2 is not None:
                h = self.BN2(h, use_running_average=deterministic)
        return h


# ---- gated layers -----------------------------------------------------------

class ResGatedGraphConv(GNNLayer):
    """Residual gated graph conv (Bresson & Laurent; reference
    conv.jl:838-867, GNNlib conv.jl:287-300): ``act(U x_i + sum_j eta_ij *
    V x_j + b)`` with ``eta_ij = sigmoid(A x_i + B x_j)``. The messages are
    dicts of endpoint gathers (``fast_gather``, whose backward is K1),
    summed by ``segment_sum``. Parameters ``A``, ``B``, ``U``, ``V`` (``[in,
    out]``) and ``bias``, as in the JAX package."""

    def __init__(self, in_features: int, out_features: int,
                 act: Callable | None = None, *, use_bias: bool = True,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        for name in ("A", "B", "U", "V"):
            setattr(self, name, _weight((in_features, out_features),
                                        generator, device, dtype))
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.act = act

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        xj, xi = _expand_srcdst(x)

        def msg(xi_e, xj_e, e):
            return torch.sigmoid(xi_e["Ax"] + xj_e["Bx"]) * xj_e["Vx"]

        m = propagate(msg, g, "sum", xi={"Ax": xi @ self.A},
                      xj={"Bx": xj @ self.B, "Vx": xj @ self.V})
        out = xi @ self.U + m[: xi.shape[0]]
        if self.bias is not None:
            out = out + self.bias
        return self.act(out) if self.act is not None else out


class GRUCell(nn.Module):
    """``flax.nnx.GRUCell``: ``dense_i`` (``nn.Linear(in, 3H)``, with a bias)
    and ``dense_h`` (``nn.Linear(H, 3H)``, none), gates in the order (r, z,
    n), ``n = tanh(xi_n + r * hh_n)`` and ``h' = (1 - z) n + z h``; called
    as ``cell(h, x)`` and returning ``h'``. ``torch.nn.GRUCell`` adds a
    trainable bias to ``hh_n``, which this layout has not."""

    def __init__(self, in_features: int, hidden_features: int, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        h3 = 3 * hidden_features
        self.dense_i = _dense(in_features, h3, True, generator, device,
                              dtype)
        self.dense_h = nn.utils.skip_init(nn.Linear, hidden_features, h3,
                                          bias=False, device=device,
                                          dtype=dtype)
        with torch.no_grad():   # flax's recurrent init: orthogonal columns
            q, r = torch.linalg.qr(torch.randn(
                (h3, hidden_features), generator=generator,
                dtype=torch.float64))
            self.dense_h.weight.copy_(q * torch.sign(torch.diagonal(r)))

    def forward(self, h, x):
        xi_r, xi_z, xi_n = self.dense_i(x).chunk(3, -1)
        hh_r, hh_z, hh_n = self.dense_h(h).chunk(3, -1)
        r = torch.sigmoid(xi_r + hh_r)
        z = torch.sigmoid(xi_z + hh_z)
        n = torch.tanh(xi_n + r * hh_n)
        return (1.0 - z) * n + z * h


class GatedGraphConv(GNNLayer):
    """Gated graph sequence NN (Li et al.; reference conv.jl:515-539, GNNlib
    conv.jl:218-233): ``num_layers`` GRU steps ``h = gru(h, aggr_j (h
    W_l)_j)``, the input zero-padded to ``out_features`` channels.
    Parameters ``weight [num_layers, out, out]`` and ``gru``
    (:class:`GRUCell`)."""

    def __init__(self, out_features: int, num_layers: int, *, aggr="sum",
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((num_layers, out_features, out_features),
                              generator, device, dtype)
        self.gru = GRUCell(out_features, out_features, generator=generator,
                           device=device, dtype=dtype)
        self.out_features = out_features
        self.num_layers = num_layers
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        din = x.shape[-1]
        if din > self.out_features:
            raise ValueError("input features must be <= out_features")
        h = nn.functional.pad(x, (0, self.out_features - din))
        for i in range(self.num_layers):
            m = propagate(copy_xj, g, self.aggr, xj=h @ self.weight[i])
            h = self.gru(h, m)
        return h


# ---- propagation family: Cheb, SG, TAG, DConv -------------------------------

def _lap_operator(g: GraphTuple, dtype):
    """Matrix-free normalized Laplacian ``v -> v - D^-1/2 A^T D^-1/2 v``
    with the weighted in-degree ``D``: one SpMM (K1) an application, over
    ``v``'s columns (the JAX package's ``_lap_operator``, conv.py:203). It
    is the symmetric Laplacian on a bidirected graph."""
    d_isqrt = _inv_sqrt(degree(g, dir="in", dtype=dtype))[:, None]
    w = None if g.edge_weight is None else g.edge_weight.to(dtype)

    def lap(v):
        xj = v * d_isqrt
        av = (propagate(copy_xj, g, "sum", xj=xj) if w is None
              else propagate(e_mul_xj, g, "sum", xj=xj, e=w))
        return v - d_isqrt * av

    return lap


def cheb_lambda_max(g: GraphTuple, dtype=torch.float32,
                    power_iters: int = 50) -> torch.Tensor:
    """Each graph's normalized-Laplacian λ_max, matrix-free (``[G]``; the
    JAX package's ``cheb_lambda_max``, conv.py:224): a power iteration of
    ``[N, G]`` columns, so K1 runs at D = G. Pass it as
    ``ChebConv(...)(g, x, lambda_max=...)`` to compute it once and not on
    every call."""
    return power_eigmax(g, _lap_operator(g, dtype), dtype, power_iters)


def _scaled_laplacian_apply(g: GraphTuple, dtype, lambda_max=None,
                            power_iters: int = 50):
    """Matrix-free ``v -> (2 L / λ_max - I) v``; ``lambda_max`` None runs
    the power iteration, a scalar or a per-graph ``[G]`` tensor skips it
    (conv.py:252)."""
    lap = _lap_operator(g, dtype)
    if lambda_max is None:
        lam = power_eigmax(g, lap, dtype, power_iters)[g.node_graph_id]
    else:
        lam = torch.as_tensor(lambda_max, dtype=dtype, device=g.device)
        lam = (lam[g.node_graph_id] if lam.dim() == 1
               else lam.expand(g.num_nodes))
    s_node = (2.0 / lam.clamp(min=1e-12))[:, None]
    return lambda v: s_node * lap(v) - v


class ChebConv(GNNLayer):
    """Chebyshev spectral convolution (reference conv.jl:162-185, GNNlib
    conv.jl:83-98): ``sum_k T_k(L~) x W_k``, ``L~ = 2 L / λ_max - I``.

    As in the JAX package (conv.py:275-316) it takes one of two paths. A
    graph of fewer than 2048 nodes with no ``lambda_max`` gets the dense
    :func:`~..query.scaled_laplacian` (out-edge convention, 100 power
    iterations); a larger graph, or a given ``lambda_max`` (a scalar or a
    ``[G]`` tensor), the matrix-free operator (in-edge convention, 50 power
    iterations when λ_max is not given, every hop one K1). The two agree
    on bidirected graphs. ``weight`` is ``[k, in, out]``.
    """

    def __init__(self, in_features: int, out_features: int, k: int, *,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((k, in_features, out_features), generator,
                              device, dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.k = k

    def forward(self, g: GraphTuple, x=None, *, lambda_max=None):
        if x is None:
            x = g.x
        if (lambda_max is not None
                or jax_n_pad(g.num_nodes) > _CHEB_DENSE_MAX_N_PAD):
            lhat = _scaled_laplacian_apply(g, x.dtype, lambda_max)
        else:
            L = scaled_laplacian(g, dtype=x.dtype)

            def lhat(v):
                return L @ v
        W = self.weight
        z_prev, z = x, lhat(x)
        y = x @ W[0]
        if self.k > 1:
            y = y + z @ W[1]
        for k in range(2, self.k):
            z, z_prev = 2.0 * lhat(z) - z_prev, z
            y = y + z @ W[k]
        return y + self.bias if self.bias is not None else y


class SGConv(GNNLayer):
    """Simplified GCN (Wu et al.; reference conv.jl:1197-1225, GNNlib
    conv.jl:501-549): ``W (D^-1/2 (A + I) D^-1/2)^k x + b``, ``W`` on the
    cheaper side as in :class:`GCNConv`."""

    def __init__(self, in_features: int, out_features: int, k: int = 1, *,
                 add_self_loops: bool = True, use_edge_weight: bool = False,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((in_features, out_features), generator, device,
                              dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.k = k
        self.add_self_loops = add_self_loops
        self.use_edge_weight = use_edge_weight

    def forward(self, g: GraphTuple, x=None, edge_weight=None):
        if x is None:
            x = g.x
        W = self.weight
        din, dout = W.shape
        if dout < din:
            x = x @ W
        kw = dict(edge_weight=edge_weight,
                  use_edge_weight=self.use_edge_weight,
                  add_self_loops=self.add_self_loops)
        c = _gcn_norm(g, norm_fn=None, dtype=x.dtype, **kw)
        for _ in range(self.k):
            x = _gcn_propagate(g, x, c, **kw)
        if dout >= din:
            x = x @ W
        return x + self.bias if self.bias is not None else x


class TAGConv(GNNLayer):
    """Topology-adaptive GCN (Du et al.; reference conv.jl:1265-1293, GNNlib
    conv.jl:634-692), with the JAX package's cumulative ``sum_pow``: hop
    ``i`` adds ``(x_1 + ... + x_i) W``."""

    def __init__(self, in_features: int, out_features: int, k: int = 3, *,
                 add_self_loops: bool = True, use_edge_weight: bool = False,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((in_features, out_features), generator, device,
                              dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.k = k
        self.add_self_loops = add_self_loops
        self.use_edge_weight = use_edge_weight

    def forward(self, g: GraphTuple, x=None, edge_weight=None):
        if x is None:
            x = g.x
        kw = dict(edge_weight=edge_weight,
                  use_edge_weight=self.use_edge_weight,
                  add_self_loops=self.add_self_loops)
        c = _gcn_norm(g, norm_fn=None, dtype=x.dtype, **kw)
        sum_pow = sum_total = None
        for _ in range(self.k):
            x = _gcn_propagate(g, x, c, **kw)
            sum_pow = x if sum_pow is None else sum_pow + x
            inc = sum_pow @ self.weight
            sum_total = inc if sum_total is None else sum_total + inc
        if self.bias is not None:
            sum_total = sum_total + self.bias
        return sum_total


class DConv(GNNLayer):
    """Diffusion conv (Li et al., DCRNN; reference conv.jl:1574-1595, GNNlib
    conv.jl:696-725) over ``g`` and ``g.reverse()``, each hop one K1 with
    the graph's own edge weights.

    By default the transition divides by the (clamped) out- and in-degrees;
    ``reference_exact=True`` multiplies by the raw degrees and keeps the
    reference's loop bounds, which apply the order-2 weights ``W[:, 1]``
    again (the JAX package's two modes, conv.py:1051-1114). ``weights`` is
    ``[2, k, in, out]``.
    """

    def __init__(self, in_features: int, out_features: int, k: int, *,
                 use_bias: bool = True, reference_exact: bool = False,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weights = _weight((2, k, in_features, out_features), generator,
                               device, dtype)
        self.bias = _bias(out_features, device, dtype) if use_bias else None
        self.k = k
        self.reference_exact = reference_exact

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        W = self.weights
        gt = g.reverse()

        def prop(graph, xj):
            # each graph's own weights (w_mul_xj with e=None), in edge order
            return propagate(w_mul_xj, graph, "sum", xj=xj)

        h = x @ W[0, 0] + x @ W[1, 0]
        T0 = x
        d_out = degree(g, dir="out", dtype=x.dtype)[:, None]
        d_in = degree(g, dir="in", dtype=x.dtype)[:, None]
        if self.reference_exact:
            # GNNlib conv.jl:705-723: raw-degree scaling, unclamped, and the
            # `for i in 2:l.k` loop that revisits the order-2 weight slot
            if self.k > 1:
                T1_out = prop(g, T0 * d_out)
                T1_in = prop(gt, T0 * d_in)
                h = h + T1_in @ W[0, 1] + T1_out @ W[1, 1]
                for i in range(1, self.k):
                    T2_in = 2.0 * prop(gt, T1_in * d_in) - T0
                    T2_out = 2.0 * prop(g, T1_out * d_out) - T0
                    h = h + T2_in @ W[0, i] + T2_out @ W[1, i]
                    T1_in, T1_out = T2_in, T2_out
            return h + self.bias if self.bias is not None else h
        d_out, d_in = d_out.clamp(min=1.0), d_in.clamp(min=1.0)
        if self.k > 1:
            T1_out = prop(g, T0 / d_out)
            T1_in = prop(gt, T0 / d_in)
            h = h + T1_in @ W[0, 1] + T1_out @ W[1, 1]
            for i in range(2, self.k):
                T2_in = 2.0 * prop(gt, T1_in / d_in) - T0
                T2_out = 2.0 * prop(g, T1_out / d_out) - T0
                h = h + T2_in @ W[0, i] + T2_out @ W[1, i]
                T1_in, T1_out = T2_in, T2_out
        return h + self.bias if self.bias is not None else h
