"""Random graph generation (host-side numpy).

Counterpart of ``graphneuralnetworks_tpu/generate.py:rand_graph``, with the
same numpy random calls, so one seed gives the same edges in both packages.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphTuple, graph
from .utils import edge_decoding, normalize_graphdata

__all__ = ["rand_graph"]


def rand_graph(num_nodes: int, num_edges: int, *, bidirected: bool = True,
               seed: int | None = None, nodes=None, edges=None,
               edge_weight=None, rng: np.random.Generator | None = None,
               device=None, **graph_kw) -> GraphTuple:
    """Erdős–Rényi G(n, m) by sampling unique edge ids (GNNGraphs
    generate.jl:41-65).

    ``bidirected=True`` samples ``num_edges / 2`` undirected pairs and
    stores both directions. ``device=None`` places the graph on the CUDA
    card.
    """
    rng = rng or np.random.default_rng(seed)
    n = int(num_nodes)
    if bidirected:
        if num_edges % 2:
            raise ValueError("bidirected rand_graph needs even num_edges")
        m = num_edges // 2
        maxid = n * (n - 1) // 2
    else:
        m = num_edges
        maxid = n * (n - 1)
    if m > maxid:
        raise ValueError("too many edges requested")
    ids = rng.choice(maxid, size=m, replace=False)
    s, r = edge_decoding(ids, n, directed=not bidirected, self_loops=False)
    if bidirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
        # features given once per undirected pair serve both directions
        edges = normalize_graphdata(edges, default_name="e", n=len(s),
                                    duplicate_if_needed=True) or None
        if edge_weight is not None and len(np.asarray(edge_weight)) == m:
            edge_weight = np.concatenate([edge_weight, edge_weight])
    return graph(s, r, num_nodes=n, nodes=nodes, edges=edges,
                 edge_weight=edge_weight, device=device, **graph_kw)
