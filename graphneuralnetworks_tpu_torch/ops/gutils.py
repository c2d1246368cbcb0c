"""Graph-wise reductions and broadcasts over batched graphs.

Counterpart of ``graphneuralnetworks_tpu/ops/gutils.py`` (reference
GNNlib/src/utils.jl:1-133): ``reduce_nodes``, ``reduce_edges``,
``softmax_nodes``, ``softmax_edges``, ``softmax_edge_neighbors``,
``broadcast_nodes``, ``broadcast_edges`` and ``edge_graph_id``. All are
segment ops keyed by the graph indicator (graph-wise) or the receiver
(neighbour-wise). The port's graphs carry no padding; the edge-wise ones
mask the edges that a graph's ``edge_valid`` marks invalid, as JAX's mask
with ``edge_mask``.

On the card every max and min among them (``reduce_*("max" | "min")`` and
the max step of each softmax) is one K14 over a CSR the graph carries:
``indptr_g`` for nodes and ``indptr_ge`` for edges by graph, the receiver
CSR of ``graph.csr_view`` for edges by receiver. A graph whose ``node_graph_id`` is not sorted has no
graph CSR; a graph-wise max of it raises on the card (JAX leaves it
undefined: its ``reduce_nodes`` passes ``indices_are_sorted=True``) and
runs on the CPU.
"""

from __future__ import annotations

import torch

from ..graph import GraphTuple
from .msgpass import _receiver_csr
from .segment import gather, is_extreme, segment_reduce, segment_softmax

__all__ = ["reduce_nodes", "reduce_edges", "softmax_nodes", "softmax_edges",
           "softmax_edge_neighbors", "broadcast_nodes", "broadcast_edges",
           "edge_graph_id"]


def _graph_csr(g: GraphTuple, indptr, t: torch.Tensor):
    """``indptr`` (a graph CSR of ``g``), or raise when a CUDA tensor needs
    one that an unsorted ``node_graph_id`` did not give."""
    if indptr is None and t.device.type == "cuda":
        raise ValueError("a graph-wise max, min or softmax on the card needs "
                         "a non-decreasing node_graph_id (as batch gives)")
    return indptr


def edge_graph_id(g: GraphTuple) -> torch.Tensor:
    """``int64[E]`` graph indicator of the edges (the receiver's graph)."""
    return gather(g.node_graph_id, g.receivers)


def reduce_nodes(aggr, g: GraphTuple, x: torch.Tensor) -> torch.Tensor:
    """Per-graph reduction of node features -> ``[num_graphs, ...]``
    (utils.jl:12-26)."""
    indptr = _graph_csr(g, g.indptr_g, x) if is_extreme(aggr) else None
    return segment_reduce(aggr, x, g.node_graph_id, g.num_graphs,
                          indptr=indptr)


def reduce_edges(aggr, g: GraphTuple, e: torch.Tensor) -> torch.Tensor:
    """Per-graph reduction of edge features (utils.jl:33-42)."""
    indptr = _graph_csr(g, g.indptr_ge, e) if is_extreme(aggr) else None
    return segment_reduce(aggr, e, edge_graph_id(g), g.num_graphs,
                          mask=g.edge_valid, indptr=indptr)


def softmax_nodes(g: GraphTuple, x: torch.Tensor) -> torch.Tensor:
    """Graph-wise softmax over nodes (utils.jl:49-59)."""
    return segment_softmax(x, g.node_graph_id, g.num_graphs,
                           indptr=_graph_csr(g, g.indptr_g, x))


def softmax_edges(g: GraphTuple, e: torch.Tensor) -> torch.Tensor:
    """Graph-wise softmax over edges (utils.jl:63-72)."""
    return segment_softmax(e, edge_graph_id(g), g.num_graphs,
                           mask=g.edge_valid,
                           indptr=_graph_csr(g, g.indptr_ge, e))


def softmax_edge_neighbors(g: GraphTuple, e: torch.Tensor) -> torch.Tensor:
    """Softmax over each node's incoming edges, the attention primitive
    (utils.jl:84-97): max-subtracted for stability; invalid edges give 0.
    Its max step is K14 on the card, over the receiver CSR of
    ``graph.csr_view``."""
    return segment_softmax(e, g.receivers, g.num_nodes, mask=g.edge_valid,
                           **_receiver_csr(g, g.num_nodes))


def broadcast_nodes(g: GraphTuple, u: torch.Tensor) -> torch.Tensor:
    """Expand a per-graph tensor ``[num_graphs, ...]`` to the nodes
    (utils.jl:105-112)."""
    return gather(u, g.node_graph_id)


def broadcast_edges(g: GraphTuple, u: torch.Tensor) -> torch.Tensor:
    """Expand a per-graph tensor to the edges (utils.jl:116-121)."""
    return gather(u, edge_graph_id(g))
