"""Layers, containers and pooling."""

from .basic import (DotDecoder, GNNChain, GNNLayer, Precision, WithGraph,
                    glorot_uniform)
from .conv import (AGNNConv, BatchNorm, ChebConv, DConv, EdgeConv, GATConv,
                   GATv2Conv, GatedGraphConv, GCNConv, GINConv, GraphConv,
                   GRUCell, MLP, ResGatedGraphConv, SAGEConv, SGConv,
                   TAGConv, TransformerConv, cheb_lambda_max)
from .pool import (GlobalAttentionPool, GlobalPool, Set2Set, TopKPool,
                   topk_index)

__all__ = ["DotDecoder", "GNNChain", "GNNLayer", "Precision", "WithGraph",
           "glorot_uniform", "AGNNConv", "BatchNorm", "EdgeConv", "GATConv",
           "GATv2Conv", "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv",
           "TransformerConv", "ResGatedGraphConv", "GatedGraphConv",
           "GRUCell", "ChebConv", "cheb_lambda_max", "SGConv", "TAGConv",
           "DConv", "GlobalAttentionPool", "GlobalPool", "Set2Set",
           "TopKPool", "topk_index"]
