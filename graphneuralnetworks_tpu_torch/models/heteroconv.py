"""HeteroGraphConv: one layer per relation, merged per destination type.

Counterpart of ``graphneuralnetworks_tpu/models/heteroconv.py`` (reference
GraphNeuralNetworks heteroconv.jl:40-86): each relation's layer runs on
:meth:`~..heterograph.HeteroGraphTuple.relation_graph` with a bipartite
``(x_src, x_dst)`` input, and the outputs that reach one destination type
are reduced with ``aggr``.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..heterograph import EType, HeteroGraphTuple
from .basic import GNNLayer

__all__ = ["HeteroGraphConv"]

_MERGE = {"sum": "sum", "+": "sum", "add": "sum", "mean": "mean",
          "max": "max", "min": "min"}


class HeteroGraphConv(GNNLayer):
    """``HeteroGraphConv({etype: layer, ...}, aggr="sum")``.

    Called with a hetero graph and ``{ntype: features}``, it returns
    ``{ntype: features}`` for every destination type of a relation. The
    layers take bipartite ``(x_src, x_dst)`` inputs (GraphConv, SAGEConv,
    GCNConv, GINConv, GATConv and GATv2Conv with ``add_self_loops=False``,
    EdgeConv, ResGatedGraphConv, ...). ``convs`` holds them in the order of
    ``etypes``, as the JAX package's ``convs`` list does; extra keyword
    arguments reach every layer. ``aggr`` is ``sum`` (``+``, ``add``),
    ``mean``, ``max`` or ``min``; another raises ``ValueError`` where two
    relations meet.
    """

    def __init__(self, layers: Mapping[EType, nn.Module] | list, *,
                 aggr: str = "sum"):
        super().__init__()
        items = list(layers.items() if isinstance(layers, Mapping)
                     else layers)
        self.etypes = [tuple(et) for et, _ in items]
        self.convs = nn.ModuleList([layer for _, layer in items])
        self.aggr = aggr

    def forward(self, g: HeteroGraphTuple, x: Mapping[str, torch.Tensor],
                **kw) -> dict:
        outs: dict[str, list] = {}
        for et, layer in zip(self.etypes, self.convs):
            src_t, _, dst_t = et
            y = layer(g.relation_graph(et), (x[src_t], x[dst_t]), **kw)
            outs.setdefault(dst_t, []).append(y)
        # heteroconv.jl:68-86, `_reduceby_node_t`, in relation order
        merged = {}
        for t, ys in outs.items():
            if len(ys) == 1:
                merged[t] = ys[0]
                continue
            how = _MERGE.get(self.aggr)
            if how is None:
                raise ValueError(f"unknown aggr {self.aggr!r}")
            m = ys[0]
            for y in ys[1:]:
                m = (m + y if how in ("sum", "mean") else
                     torch.maximum(m, y) if how == "max" else
                     torch.minimum(m, y))
            merged[t] = m / len(ys) if how == "mean" else m
        return merged
