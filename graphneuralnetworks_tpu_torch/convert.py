"""Converters: adjacency list, scipy sparse, dense.

Counterpart of ``graphneuralnetworks_tpu/convert.py`` (reference GNNGraphs
convert.jl: ``to_coo`` from an adjacency list, dense or sparse matrix,
``to_dense``, ``to_sparse``). The constructors place the graph on ``device``
(``None``: the CUDA card); the exports come back on the host.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphTuple, from_dense_adjacency, graph

__all__ = ["from_adjacency_list", "to_scipy_sparse", "from_scipy_sparse",
           "to_dense_adjacency", "from_dense_adjacency"]


def from_adjacency_list(adj_list, **kw) -> GraphTuple:
    """Build from ``adj_list[i]``, the out-neighbours of ``i``
    (convert.jl:3-27)."""
    s = np.repeat(np.arange(len(adj_list), dtype=np.int64),
                  [len(nbrs) for nbrs in adj_list])
    r = np.asarray([int(j) for nbrs in adj_list for j in nbrs], np.int64)
    kw.setdefault("num_nodes", len(adj_list))
    return graph(s, r, **kw)


def to_scipy_sparse(g: GraphTuple):
    """The adjacency as a scipy CSR matrix, ``A[s, r] = w`` (the sum over
    parallel edges; ones without weights), on the host."""
    import scipy.sparse as sp
    s = g.senders.cpu().numpy()
    r = g.receivers.cpu().numpy()
    w = (g.edge_weight.detach().cpu().numpy() if g.edge_weight is not None
         else np.ones(g.num_edges, np.float32))
    return sp.csr_matrix((w, (s, r)), shape=(g.num_nodes, g.num_nodes))


def from_scipy_sparse(A, **kw) -> GraphTuple:
    """Build from any scipy sparse matrix; its values become edge weights
    unless all are 1."""
    coo = A.tocoo()
    w = coo.data
    kw.setdefault("num_nodes", A.shape[0])
    if not np.all(w == 1):
        kw.setdefault("edge_weight", w.astype(np.float32))
    return graph(coo.row, coo.col, **kw)


def to_dense_adjacency(g: GraphTuple) -> np.ndarray:
    """The dense ``[N, N]`` float32 adjacency on the host
    (convert.jl:165-189; :func:`~.query.adjacency_matrix`). The JAX
    package's ``trim`` cut its padding; the port has none."""
    from .query import adjacency_matrix
    return adjacency_matrix(g).cpu().numpy()
