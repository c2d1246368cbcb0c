"""Layers, containers and pooling."""

from .basic import DotDecoder, GNNChain, GNNLayer, WithGraph, glorot_uniform
from .conv import (AGNNConv, BatchNorm, EdgeConv, GATConv, GATv2Conv,
                   GCNConv, GINConv, GraphConv, MLP, SAGEConv,
                   TransformerConv)
from .pool import (GlobalAttentionPool, GlobalPool, Set2Set, TopKPool,
                   topk_index)

__all__ = ["DotDecoder", "GNNChain", "GNNLayer", "WithGraph",
           "glorot_uniform", "AGNNConv", "BatchNorm", "EdgeConv", "GATConv",
           "GATv2Conv", "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv",
           "TransformerConv", "GlobalAttentionPool", "GlobalPool", "Set2Set",
           "TopKPool", "topk_index"]
