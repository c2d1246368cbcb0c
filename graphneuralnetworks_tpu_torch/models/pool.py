"""Graph pooling layers: GlobalPool, GlobalAttentionPool, TopKPool, Set2Set.

Counterpart of ``graphneuralnetworks_tpu/models/pool.py`` (reference
GraphNeuralNetworks/src/layers/pool.jl:35-162, GNNlib/src/layers/
pool.jl:1-43). All are segment reductions keyed by the graph indicator, so
they work on batched graphs; on the card their max steps run on K14 over
the batch's graph CSR (:mod:`..ops.gutils`).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphTuple
from ..ops.gutils import broadcast_nodes, reduce_nodes, softmax_nodes
from .basic import GNNLayer, glorot_uniform

__all__ = ["GlobalPool", "GlobalAttentionPool", "TopKPool", "Set2Set",
           "topk_index"]


def _top_k(y: torch.Tensor, k: int):
    """The ``k`` largest entries along the last axis and their indices,
    ties to the lowest index (``jax.lax.top_k``'s rule; ``torch.topk``
    promises no order among ties, a stable sort does)."""
    vals, idx = torch.sort(y, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_index(y: torch.Tensor, k: int, *, g: GraphTuple | None = None):
    """Indices of the ``k`` largest entries of the score vector ``y``
    (GNNlib/src/layers/pool.jl:22-27), exactly ``k`` of them, sorted by
    descending score, ties to the lowest index.

    Without ``g``: ``(values [k], indices [k])`` over the whole vector.
    With a (batched) graph ``g``: per-graph top-k, ``(values [G, k],
    indices [G, k])`` with global node indices; a graph with fewer than
    ``k`` nodes fills its tail with ``-inf`` values whose indices point at
    other graphs' nodes (check ``values`` for finiteness).
    """
    if y.dim() != 1:
        raise ValueError(f"topk_index expects a score vector, got "
                         f"{tuple(y.shape)}")
    if g is None:
        return _top_k(y, k)
    mine = g.node_graph_id[None, :] == torch.arange(
        g.num_graphs, device=y.device)[:, None]
    per_graph = torch.where(mine, y[None, :], y.new_tensor(float("-inf")))
    return _top_k(per_graph, k)


class GlobalPool(GNNLayer):
    """Per-graph reduction of node features -> ``[num_graphs, D]``
    (pool.jl:35-41): ``reduce_nodes(aggr, g, x)``."""

    def __init__(self, aggr="sum"):
        super().__init__()
        self.aggr = aggr

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        return reduce_nodes(self.aggr, g, x)


class GlobalAttentionPool(GNNLayer):
    """Gated attention pooling (Li et al.; pool.jl:88-99, GNNlib
    pool.jl:7-12): ``u = sum_i softmax_nodes(fgate(x))_i * ffeat(x)_i``."""

    def __init__(self, fgate, ffeat=None):
        super().__init__()
        self.fgate = fgate
        self.ffeat = ffeat

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        alpha = softmax_nodes(g, self.fgate(x))
        feats = alpha * (self.ffeat(x) if self.ffeat is not None else x)
        return reduce_nodes("sum", g, feats)


class TopKPool(GNNLayer):
    """Top-k node pooling (Gao & Ji; pool.jl:112-123, GNNlib pool.jl:14-27):
    score ``y = x p / |p|``, keep the top ``k`` nodes, scale their features
    by ``sigmoid(y)``. Returns ``(x_pooled [k, D], idx [k])`` for a single
    (non-batched) graph. ``p`` is ``[in, 1]``, Glorot-initialised, as in the
    JAX package."""

    def __init__(self, in_features: int, k: int, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.p = nn.Parameter(glorot_uniform((in_features, 1),
                                             generator=generator,
                                             dtype=dtype, device=device))
        self.k = k

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        p = self.p[:, 0]
        y = x @ p / torch.linalg.vector_norm(p).clamp(min=1e-12)
        topv, topi = topk_index(y, self.k)
        return x[topi] * torch.sigmoid(topv)[:, None], topi


class Set2Set(GNNLayer):
    """Set2Set pooling (Vinyals et al.; pool.jl:144-162, GNNlib
    pool.jl:29-43) -> ``[num_graphs, 2 D]``: ``n_iters`` rounds of an LSTM
    query, attention over each graph's nodes and a weighted readout, from a
    zero carry.

    The LSTM is a ``torch.nn.LSTMCell(2 D, D)``. JAX's
    ``nnx.OptimizedLSTMCell`` holds ``dense_i.kernel [2D, 4D]`` (no bias),
    ``dense_h.kernel [D, 4D]`` and ``dense_h.bias [4D]``, gates in the same
    order (i, f, g, o); :func:`~..interop.load_jax_params` maps them to
    ``weight_ih``, ``weight_hh`` and ``bias_hh``, with ``bias_ih`` 0. Here
    both weights start Glorot-uniform from ``generator`` and both biases at
    0.
    """

    def __init__(self, in_features: int, n_iters: int, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        d = in_features
        self.lstm = nn.LSTMCell(2 * d, d, device=device, dtype=dtype)
        with torch.no_grad():
            for w in (self.lstm.weight_ih, self.lstm.weight_hh):
                w.copy_(glorot_uniform(tuple(w.shape), generator=generator,
                                       dtype=dtype, device=device))
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        self.n_iters = n_iters
        self.in_features = d

    def forward(self, g: GraphTuple, x=None):
        if x is None:
            x = g.x
        n_graphs, d = g.num_graphs, self.in_features
        qstar = x.new_zeros((n_graphs, 2 * d))
        h = c = x.new_zeros((n_graphs, d))
        for _ in range(self.n_iters):
            h, c = self.lstm(qstar, (h, c))                   # q = h
            qn = broadcast_nodes(g, h)                        # [N, D]
            alpha = softmax_nodes(g, (qn * x).sum(-1, keepdim=True))
            r = reduce_nodes("sum", g, x * alpha)             # [G, D]
            qstar = torch.cat([h, r], -1)
        return qstar
