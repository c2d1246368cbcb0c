"""Layers, containers, pooling, and the hetero and recurrent layers."""

from .basic import (DotDecoder, GNNChain, GNNLayer, Precision, WithGraph,
                    glorot_uniform)
from .conv import (AGNNConv, BatchNorm, CGConv, ChebConv, DConv, EdgeConv,
                   EGNNConv, GATConv, GATv2Conv, GatedGraphConv, GCNConv,
                   GINConv, GMMConv, GraphConv, GRUCell, MEGNetConv, MLP,
                   NNConv, ResGatedGraphConv, SAGEConv, SGConv, TAGConv,
                   TransformerConv, cheb_lambda_max)
from .heteroconv import HeteroGraphConv
from .temporalconv import (A3TGCN, DCGRU, DCGRUCell, EvolveGCNO,
                           EvolveGCNOCell, GConvGRU, GConvGRUCell, GConvLSTM,
                           GConvLSTMCell, GNNRecurrence, TGCN, TGCNCell)
from .pool import (GlobalAttentionPool, GlobalPool, Set2Set, TopKPool,
                   topk_index)

__all__ = ["DotDecoder", "GNNChain", "GNNLayer", "Precision", "WithGraph",
           "glorot_uniform", "AGNNConv", "BatchNorm", "EdgeConv", "GATConv",
           "GATv2Conv", "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv",
           "TransformerConv", "ResGatedGraphConv", "GatedGraphConv",
           "GRUCell", "ChebConv", "cheb_lambda_max", "SGConv", "TAGConv",
           "DConv", "NNConv", "CGConv", "MEGNetConv", "GMMConv", "EGNNConv",
           "GlobalAttentionPool", "GlobalPool", "Set2Set",
           "TopKPool", "topk_index", "HeteroGraphConv", "GNNRecurrence",
           "GConvGRUCell", "GConvLSTMCell", "DCGRUCell", "EvolveGCNOCell",
           "TGCNCell", "GConvGRU", "GConvLSTM", "DCGRU", "EvolveGCNO", "TGCN",
           "A3TGCN"]
