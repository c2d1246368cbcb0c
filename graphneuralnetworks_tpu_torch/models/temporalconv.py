"""Recurrent graph layers: GNNRecurrence and its cells.

Counterpart of ``graphneuralnetworks_tpu/models/temporalconv.py``
(reference GraphNeuralNetworks temporalconv.jl: ``GNNRecurrence``
:121-139, ``GConvGRUCell`` :200-258, ``GConvLSTMCell`` :355-441,
``DCGRUCell`` :537-579, ``EvolveGCNOCell`` :678-709, ``TGCNCell``
:809-853, the constructors; ``A3TGCN`` from GNNLux temporalconv.jl:
149-183). Time is the leading axis: on a static graph the features are
``[T, N, D]`` and :class:`GNNRecurrence` runs the cell in a Python loop
over T (the JAX package's ``lax.scan``). The cells ride ported layers, so
every hop is one SpMM (K1): ChebConv (GConvGRU, GConvLSTM), DConv (DCGRU),
GCNConv (TGCN, EvolveGCNO).

A cell is ``cell(g, x, state=None, **context) -> (y, state)`` with
``cell.initial_state(g, x)``. A cell with ``static_context(g, x)`` (the
ChebConv cells: λ_max by :func:`~.conv.cheb_lambda_max`) has it computed
once per :class:`GNNRecurrence` call on a static graph, before the loop,
and passed to every step; called alone, such a cell computes it per step.
Parameters keep the JAX package's names, so ``interop.load_jax_params``
maps them one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphTuple
from ..temporal import TemporalGraph
from .basic import GNNChain, GNNLayer, glorot_uniform
from .conv import ChebConv, DConv, GCNConv, _bias, _dense, cheb_lambda_max

__all__ = ["GNNRecurrence", "GConvGRUCell", "GConvLSTMCell", "DCGRUCell",
           "EvolveGCNOCell", "TGCNCell", "GConvGRU", "GConvLSTM", "DCGRU",
           "EvolveGCNO", "TGCN", "A3TGCN"]


class GNNRecurrence(GNNLayer):
    """Apply a graph recurrent cell over a temporal sequence
    (temporalconv.jl:121-139).

    ``layer(g, x)`` with a static :class:`~.graph.GraphTuple` and ``x [T,
    N, D]`` returns ``[T, N, out]``; with a :class:`~..temporal.
    TemporalGraph` and one feature tensor per snapshot (a list, or a
    tensor whose leading axis is time) a list of per-snapshot outputs.
    ``state`` is the cell's initial state (default: its zeros). Keyword
    arguments go to every step on a static graph in place of the cell's
    ``static_context`` (``lambda_max=``, computed once by
    :func:`~.conv.cheb_lambda_max` and kept across calls, for the
    ChebConv cells).
    """

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell

    def initial_state(self, g, x):
        return self.cell.initial_state(g, x)

    def forward(self, g, x, state=None, **context):
        cell = self.cell
        if isinstance(g, TemporalGraph):
            if context:
                raise ValueError("a TemporalGraph takes no step context: "
                                 "each snapshot is its own graph")
            xs = list(x)
            if state is None:
                state = cell.initial_state(g.snapshots[0], xs[0])
            outs = []
            for gt, xt in zip(g.snapshots, xs):
                yt, state = cell(gt, xt, state)
                outs.append(yt)
            return outs
        if state is None:
            state = cell.initial_state(g, x[0])
        # loop-invariant context (the ChebConv cells' λ_max), once per call
        prep = getattr(cell, "static_context", None)
        ctx = context or (prep(g, x[0]) if prep is not None else {})
        ys = []
        for xt in x:
            yt, state = cell(g, xt, state, **ctx)
            ys.append(yt)
        return torch.stack(ys)


def _zeros(x, width):
    return x.new_zeros((x.shape[0], width))


class _ChebCell(GNNLayer):
    """The ChebConv cells' shared parts: one λ_max for every conv of a step
    (given, from ``static_context``, or computed)."""

    def initial_state(self, g, x):
        return _zeros(x, self.out_features)

    def static_context(self, g, x) -> dict:
        """The loop-invariant context for :class:`GNNRecurrence`: λ_max."""
        return {"lambda_max": cheb_lambda_max(g, x.dtype)}

    @staticmethod
    def _lam(g, dtype, lambda_max):
        return cheb_lambda_max(g, dtype) if lambda_max is None else lambda_max


class GConvGRUCell(_ChebCell):
    """ChebConv-based GRU cell (Seo et al.; temporalconv.jl:200-258). State:
    ``h [N, out]``. Every ChebConv takes the matrix-free path with one
    λ_max (a default, per-step power iteration otherwise runs six times a
    step)."""

    def __init__(self, in_features: int, out_features: int, k: int, *,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=use_bias, generator=generator,
                  device=resolve_device(device), dtype=dtype)
        for gate in ("r", "z", "h"):
            setattr(self, f"conv_x_{gate}",
                    ChebConv(in_features, out_features, k, **kw))
            setattr(self, f"conv_h_{gate}",
                    ChebConv(out_features, out_features, k, **kw))
        self.out_features = out_features

    def forward(self, g: GraphTuple, x, h=None, *, lambda_max=None):
        if h is None:
            h = self.initial_state(g, x)
        lam = self._lam(g, x.dtype, lambda_max)
        r = torch.sigmoid(self.conv_x_r(g, x, lambda_max=lam)
                          + self.conv_h_r(g, h, lambda_max=lam))
        z = torch.sigmoid(self.conv_x_z(g, x, lambda_max=lam)
                          + self.conv_h_z(g, h, lambda_max=lam))
        htilde = torch.tanh(self.conv_x_h(g, x, lambda_max=lam)
                            + self.conv_h_h(g, r * h, lambda_max=lam))
        h = (1.0 - z) * htilde + z * h
        return h, h


class GConvLSTMCell(_ChebCell):
    """ChebConv-based LSTM cell with peephole weights (Seo et al.;
    temporalconv.jl:355-441). State: ``(h, c)``. Per gate ``conv_x_*``,
    ``conv_h_*``, the peephole vector ``w_* [out]`` and ``b_* [out]`` (None
    without ``use_bias``)."""

    def __init__(self, in_features: int, out_features: int, k: int, *,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(use_bias=use_bias, generator=generator, device=device,
                  dtype=dtype)
        for gate in ("i", "f", "c", "o"):
            setattr(self, f"conv_x_{gate}",
                    ChebConv(in_features, out_features, k, **kw))
            setattr(self, f"conv_h_{gate}",
                    ChebConv(out_features, out_features, k, **kw))
            setattr(self, f"w_{gate}", nn.Parameter(glorot_uniform(
                (out_features, 1), generator=generator, dtype=dtype,
                device=device)[:, 0]))
            setattr(self, f"b_{gate}", _bias(out_features, device, dtype)
                    if use_bias else None)
        self.out_features = out_features

    def initial_state(self, g, x):
        z = _zeros(x, self.out_features)
        return (z, z)

    def _gate(self, name, g, x, h, c, lam):
        out = (getattr(self, f"conv_x_{name}")(g, x, lambda_max=lam)
               + getattr(self, f"conv_h_{name}")(g, h, lambda_max=lam)
               + getattr(self, f"w_{name}") * c)
        b = getattr(self, f"b_{name}")
        return out + b if b is not None else out

    def forward(self, g: GraphTuple, x, state=None, *, lambda_max=None):
        if state is None:
            state = self.initial_state(g, x)
        h, c = state
        lam = self._lam(g, x.dtype, lambda_max)
        i = torch.sigmoid(self._gate("i", g, x, h, c, lam))
        f = torch.sigmoid(self._gate("f", g, x, h, c, lam))
        c = f * c + i * torch.tanh(self._gate("c", g, x, h, c, lam))
        o = torch.sigmoid(self._gate("o", g, x, h, c, lam))   # the new c
        h = o * torch.tanh(c)
        return h, (h, c)


class DCGRUCell(GNNLayer):
    """Diffusion-convolutional GRU (DCRNN, Li et al.; temporalconv.jl:
    537-579): the gates ``dconv_u``, ``dconv_r``, ``dconv_c`` are DConvs on
    ``[x; h]``. State: ``h [N, out]``."""

    def __init__(self, in_features: int, out_features: int, k: int, *,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=use_bias, generator=generator,
                  device=resolve_device(device), dtype=dtype)
        for gate in ("u", "r", "c"):
            setattr(self, f"dconv_{gate}",
                    DConv(in_features + out_features, out_features, k, **kw))
        self.out_features = out_features

    def initial_state(self, g, x):
        return _zeros(x, self.out_features)

    def forward(self, g: GraphTuple, x, h=None):
        if h is None:
            h = self.initial_state(g, x)
        xh = torch.cat([x, h], -1)
        z = torch.sigmoid(self.dconv_u(g, xh))
        r = torch.sigmoid(self.dconv_r(g, xh))
        c = torch.tanh(self.dconv_c(g, torch.cat([x, h * r], -1)))
        h = z * h + (1.0 - z) * c
        return h, h


class EvolveGCNOCell(GNNLayer):
    """EvolveGCN-O (Pareja et al.; temporalconv.jl:678-709): a GCN whose
    weight evolves through an LSTM, for snapshots that vary over time.

    The state is ``{"weight": [in * out], "lstm": (c, h)}``, the LSTM's
    carry in the JAX package's order. Each step feeds the previous weight,
    flattened row-major and unbatched, to ``lstm`` (``torch.nn.LSTMCell(in *
    out, in * out)``, whose own carry is ``(h, c)``); its new ``h`` is the
    conv's ``[in, out]`` weight (``GCNConv(conv_weight=)``).
    """

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.conv = GCNConv(in_features, out_features, use_bias=use_bias,
                            generator=generator, device=device, dtype=dtype)
        d = in_features * out_features
        self.lstm = nn.LSTMCell(d, d, device=device, dtype=dtype)
        with torch.no_grad():
            for w in (self.lstm.weight_ih, self.lstm.weight_hh):
                w.copy_(glorot_uniform(tuple(w.shape), generator=generator,
                                       dtype=dtype, device=device))
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        self.in_features, self.out_features = in_features, out_features

    def initial_state(self, g, x):
        w = self.conv.weight.reshape(-1)
        z = w.new_zeros(w.shape)
        return {"weight": w, "lstm": (z, z)}

    def forward(self, g: GraphTuple, x, state=None):
        if state is None:
            state = self.initial_state(g, x)
        c, h = state["lstm"]
        h, c = self.lstm(state["weight"], (h, c))
        W = h.reshape(self.in_features, self.out_features)
        y = self.conv(g, x, conv_weight=W)
        return y, {"weight": h, "lstm": (c, h)}


class TGCNCell(GNNLayer):
    """T-GCN cell (Zhao et al.; temporalconv.jl:809-853): per gate a
    ``GNNChain(GCNConv(in, out, relu), GCNConv(out, out))`` on ``x``
    (``conv_z``, ``conv_r``, ``conv_h``) and a Dense on ``[conv; h]``
    (``dense_z``, ``dense_r``, ``dense_h``, Glorot). State: ``h [N,
    out]``."""

    def __init__(self, in_features: int, out_features: int, *,
                 add_self_loops: bool = True, use_bias: bool = True,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(add_self_loops=add_self_loops, use_bias=use_bias,
                  generator=generator, device=device, dtype=dtype)
        for gate in ("z", "r", "h"):
            setattr(self, f"conv_{gate}", GNNChain(
                GCNConv(in_features, out_features, torch.relu, **kw),
                GCNConv(out_features, out_features, **kw)))
            setattr(self, f"dense_{gate}", _dense(
                2 * out_features, out_features, use_bias, generator, device,
                dtype))
        self.out_features = out_features

    def initial_state(self, g, x):
        return _zeros(x, self.out_features)

    def forward(self, g: GraphTuple, x, h=None):
        if h is None:
            h = self.initial_state(g, x)
        z = torch.sigmoid(self.dense_z(torch.cat([self.conv_z(g, x), h], -1)))
        r = torch.sigmoid(self.dense_r(torch.cat([self.conv_r(g, x), h], -1)))
        htilde = torch.tanh(self.dense_h(
            torch.cat([self.conv_h(g, x), r * h], -1)))
        h = (1.0 - z) * h + z * htilde
        return h, h


def GConvGRU(in_features, out_features, k, **kw) -> GNNRecurrence:
    """temporalconv.jl:293."""
    return GNNRecurrence(GConvGRUCell(in_features, out_features, k, **kw))


def GConvLSTM(in_features, out_features, k, **kw) -> GNNRecurrence:
    """temporalconv.jl:477."""
    return GNNRecurrence(GConvLSTMCell(in_features, out_features, k, **kw))


def DCGRU(in_features, out_features, k, **kw) -> GNNRecurrence:
    """temporalconv.jl:613."""
    return GNNRecurrence(DCGRUCell(in_features, out_features, k, **kw))


def EvolveGCNO(in_features, out_features, **kw) -> GNNRecurrence:
    """temporalconv.jl:752."""
    return GNNRecurrence(EvolveGCNOCell(in_features, out_features, **kw))


def TGCN(in_features, out_features, **kw) -> GNNRecurrence:
    """temporalconv.jl:884."""
    return GNNRecurrence(TGCNCell(in_features, out_features, **kw))


class A3TGCN(GNNLayer):
    """Attention temporal GCN (GNNLux temporalconv.jl:149-183): TGCN over
    the sequence (``tgcn``), each step scored by ``dense2(dense1(h))``, a
    softmax over time (axis 0), and the weighted sum ``[N, out]``. Over a
    :class:`~..temporal.TemporalGraph` the per-snapshot outputs are stacked
    and must share one shape (``from_snapshots(uniform=True)`` pads
    snapshots of unequal sizes to one, as JAX's does), else
    ``ValueError``."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator=None, device=None, dtype=torch.float32, **kw):
        super().__init__()
        device = resolve_device(device)
        self.tgcn = TGCN(in_features, out_features, generator=generator,
                         device=device, dtype=dtype, **kw)
        self.dense1 = _dense(out_features, out_features, True, generator,
                             device, dtype)
        self.dense2 = _dense(out_features, out_features, True, generator,
                             device, dtype)

    def forward(self, g, x, state=None):
        h = self.tgcn(g, x, state)               # [T, N, out]
        if isinstance(h, (list, tuple)):
            shapes = {tuple(t.shape) for t in h}
            if len(shapes) != 1:
                raise ValueError(
                    "A3TGCN over a TemporalGraph needs one output shape per "
                    f"snapshot for the softmax over time; got "
                    f"{sorted(shapes)}: build the graph with "
                    "from_snapshots(..., uniform=True)")
            h = torch.stack(h)
        a = torch.softmax(self.dense2(self.dense1(h)), dim=0)
        return (a * h).sum(0)
