"""Graph transforms: ``batch``.

Counterpart of ``graphneuralnetworks_tpu/transform.py:batch`` (reference
``MLUtils.batch(::Vector{GNNGraph})``, transform.jl:671-713). The batch is
built on the host and placed on ``device`` at true size, with no padding;
its ``node_graph_id`` is non-decreasing, so the batch carries the graph
CSRs (``indptr_g``, ``indptr_ge``) that the graph-wise ops run on. The
other transforms of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .graph import GraphTuple, graph, no_edge_valid

__all__ = ["batch"]


def _host(t):
    return t.detach().cpu().numpy()


def _cat(dicts, sizes) -> dict:
    """Concatenate feature dicts; a key missing from a graph gives zeros of
    the other graphs' trailing shape and dtype."""
    keys = sorted(set().union(*dicts))
    out = {}
    for k in keys:
        proto = next(d[k] for d in dicts if k in d)
        out[k] = np.concatenate([
            d[k] if k in d else np.zeros((n,) + proto.shape[1:], proto.dtype)
            for d, n in zip(dicts, sizes)])
    return out


def batch(graphs: Sequence[GraphTuple], *, device=None) -> GraphTuple:
    """Batch graphs into one block-diagonal graph: node ids offset by the
    running node count, features concatenated, ``node_graph_id`` the
    position of each node's graph, ``num_graphs = len(graphs)``.
    ``device=None`` places the batch on the CUDA card."""
    if not graphs:
        raise ValueError("batch needs at least one graph")
    for g in graphs:
        no_edge_valid(g, "batch")
    sizes_n = [g.num_nodes for g in graphs]
    sizes_e = [g.num_edges for g in graphs]
    off = np.cumsum([0] + sizes_n)
    s = np.concatenate([_host(g.senders) + off[i]
                        for i, g in enumerate(graphs)])
    r = np.concatenate([_host(g.receivers) + off[i]
                        for i, g in enumerate(graphs)])
    gid = np.concatenate([np.full(n, i, np.int64)
                          for i, n in enumerate(sizes_n)])
    w = None
    if any(g.edge_weight is not None for g in graphs):
        w = np.concatenate([
            _host(g.edge_weight) if g.edge_weight is not None
            else np.ones(n, np.float32) for g, n in zip(graphs, sizes_e)])

    def feats(what, sizes):
        return _cat([{k: _host(v) for k, v in getattr(g, what).items()}
                     for g in graphs], sizes) or None

    return graph(s, r, num_nodes=int(off[-1]), nodes=feats("nodes", sizes_n),
                 edges=feats("edges", sizes_e),
                 globals_=feats("globals_", [g.num_graphs for g in graphs]),
                 edge_weight=w, node_graph_id=gid, num_graphs=len(graphs),
                 device=device)
