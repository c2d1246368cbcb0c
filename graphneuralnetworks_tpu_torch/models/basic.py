"""Model basics: GNNLayer base, GNNChain, WithGraph, Precision, DotDecoder,
Glorot init.

Counterpart of ``graphneuralnetworks_tpu/models/basic.py`` (reference
GraphNeuralNetworks basic.jl). Layers are ``torch.nn.Module``s taking
``(g, x, ...)`` with features-last tensors ``[num_nodes, D]``.
"""

from __future__ import annotations

import inspect
import math

import torch
from torch import nn
from torch.utils import _pytree

from .. import resolve_device
from ..graph import GraphTuple
from ..ops.msgpass import apply_edges, xi_dot_xj

__all__ = ["GNNLayer", "GNNChain", "WithGraph", "Precision", "DotDecoder",
           "glorot_uniform"]


def glorot_uniform(shape, *, generator: torch.Generator | None = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Glorot (Xavier) uniform: ``U(-a, a)`` with ``a = sqrt(6 / (shape[-2]
    + shape[-1]) / r)``, ``r`` the product of the leading dimensions (1 for
    a 2-D ``shape``), as flax's ``glorot_uniform`` counts fans. Drawn on the
    CPU from ``generator`` so that one seed gives one init on any device."""
    *lead, fan_a, fan_b = shape
    limit = math.sqrt(6.0 / (fan_a + fan_b) / math.prod(lead))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2 * u - 1) * limit).to(dtype=dtype,
                                    device=resolve_device(device))


class GNNLayer(nn.Module):
    """Base class for graph layers: ``layer(g, x, ...) -> tensor``.

    ``layer.on_graph(g)`` returns ``g`` with its node feature updated
    (graph-in/graph-out, reference basic.jl:12).
    """

    def on_graph(self, g: GraphTuple, key: str = "x", **kw) -> GraphTuple:
        out = self(g, g.nodes[key], **kw)
        return g.replace(nodes={**g.nodes, key: out})


class _Fn(nn.Module):
    """A plain callable (an activation, say) as a chain element."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(x, **kw)


def _as_module(layer) -> nn.Module:
    return layer if isinstance(layer, nn.Module) else _Fn(layer)


class GNNChain(GNNLayer):
    """Sequential container aware of the graph argument (reference
    basic.jl:106-185).

    Graph layers (:class:`GNNLayer`) get ``(g, x)``; other modules and plain
    callables get the features only. Extra keyword arguments reach every
    layer whose signature accepts them.
    """

    def __init__(self, *layers, **named_layers):
        super().__init__()
        if layers and named_layers:
            raise ValueError("pass layers positionally or by name, not both")
        items = (list(enumerate(layers)) if layers
                 else list(named_layers.items()))
        self._names = [str(k) for k, _ in items]
        self.layers = nn.ModuleList([_as_module(v) for _, v in items])

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.layers[self._names.index(i)]
        if isinstance(i, slice):
            chain = GNNChain()
            chain._names = self._names[i]
            chain.layers = nn.ModuleList(list(self.layers)[i])
            return chain
        return self.layers[i]

    def __len__(self):
        return len(self.layers)

    def forward(self, g: GraphTuple, x=None, **kw):
        if x is None:
            x = g.x
        for layer in self.layers:
            x = _apply_layer(layer, g, x, **kw)
        return x


def _filter_kw(fn, kw: dict) -> dict:
    """The subset of ``kw`` that ``fn`` accepts (by name or ``**kwargs``)."""
    if not kw:
        return kw
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {}
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return kw
    return {k: v for k, v in kw.items() if k in params}


def _apply_layer(layer, g, x, **kw):
    if isinstance(layer, GNNChain):
        return layer(g, x, **kw)
    if isinstance(layer, GNNLayer):
        return layer(g, x, **_filter_kw(layer.forward, kw))
    if isinstance(layer, _Fn):
        return layer.fn(x, **_filter_kw(layer.fn, kw))
    return layer(x, **_filter_kw(layer.forward, kw))


class WithGraph(nn.Module):
    """Close a model over a fixed graph: ``WithGraph(model, g)(x)``
    (reference basic.jl:40-52).

    ``traingraph=True`` makes the graph's float feature tensors trainable
    parameters; the edge structure stays data. Calling with an explicit
    graph, ``wg(g2, x2)``, bypasses the stored one.
    """

    def __init__(self, model, g: GraphTuple, *, traingraph: bool = False):
        super().__init__()
        self.model = model
        self.traingraph = traingraph
        if traingraph:
            def params(d):
                return nn.ParameterDict({
                    k: nn.Parameter(v, requires_grad=v.is_floating_point())
                    for k, v in d.items()})
            self._nfeat = params(g.nodes)
            self._efeat = params(g.edges)
            self._gfeat = params(g.globals_)
            self.g = g.replace(nodes={}, edges={}, globals_={})
        else:
            self.g = g

    def _graph(self) -> GraphTuple:
        if not self.traingraph:
            return self.g
        return self.g.replace(nodes=dict(self._nfeat.items()),
                              edges=dict(self._efeat.items()),
                              globals_=dict(self._gfeat.items()))

    def forward(self, x=None, *args, **kw):
        if isinstance(x, GraphTuple):
            return self.model(x, *args, **kw)
        return self.model(self._graph(), x, *args, **kw)


class Precision(GNNLayer):
    """Run a layer or chain in ``dtype`` (bfloat16 by default) with float32
    master parameters (JAX ``models/basic.py:148-184``).

    At call time every floating parameter and buffer of ``module``, and
    every floating tensor in ``x``, ``*args`` and ``**kw`` (nested in
    lists, tuples and dicts too), is cast to ``dtype``; the graph is left
    as it is. ``module`` then runs entirely in ``dtype`` through
    ``torch.func.functional_call``, so gradients flow back through the
    casts and reach the parameters in their own type: the optimizer's
    state and updates stay float32. Every kernel (K1-K14, ``ops/cuda``)
    takes bfloat16 and keeps its sums and softmax state in float32. This
    is not ``torch.autocast``, which keeps some ops in float32 and casts
    per op.

    Example::

        model = Precision(GNNChain(GCNConv(16, 32, torch.relu),
                                   GATConv(32, 8)))
        y = model(g, x)            # bfloat16
        loss = f(y.float())
    """

    def __init__(self, module: nn.Module, dtype=torch.bfloat16):
        super().__init__()
        self.module = module
        self.dtype = dtype

    def _cast(self, v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(self.dtype)
        return v

    def forward(self, g: GraphTuple, x=None, *args, **kw):
        state = {name: self._cast(t) for name, t in
                 [*self.module.named_parameters(),
                  *self.module.named_buffers()]}
        x, args, kw = _pytree.tree_map(self._cast, (x, args, kw))
        return torch.func.functional_call(self.module, state,
                                          (g, x, *args), kw)


class DotDecoder(GNNLayer):
    """Per-edge dot product of endpoint features -> ``[E, 1]``, the
    link-prediction decoder (reference basic.jl:210-212). On the card one
    SDDMM (K13)."""

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        return apply_edges(xi_dot_xj, g, xi=x, xj=x)
