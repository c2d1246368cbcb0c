"""Graph set operators.

Counterpart of ``graphneuralnetworks_tpu/operators.py`` (reference
GNNGraphs operators.jl:7-18).
"""

from __future__ import annotations

import numpy as np

from .graph import GraphTuple, graph

__all__ = ["intersect_graphs"]


def intersect_graphs(g1: GraphTuple, g2: GraphTuple) -> GraphTuple:
    """The edges of both graphs, once each, over the larger node count
    (operators.jl:7-18), in (sender, receiver) order before the build
    groups them by receiver; on ``g1``'s device."""
    n = max(g1.num_nodes, g2.num_nodes)

    def keys(g):
        return g.senders.cpu().numpy() * n + g.receivers.cpu().numpy()

    common = np.intersect1d(keys(g1), keys(g2))
    return graph(common // n, common % n, num_nodes=n, device=g1.device)
