"""Layers and containers."""

from .basic import DotDecoder, GNNChain, GNNLayer, WithGraph, glorot_uniform
from .conv import (AGNNConv, BatchNorm, GATConv, GATv2Conv, GCNConv, GINConv,
                   GraphConv, MLP, SAGEConv, TransformerConv)

__all__ = ["DotDecoder", "GNNChain", "GNNLayer", "WithGraph",
           "glorot_uniform", "AGNNConv", "BatchNorm", "GATConv", "GATv2Conv",
           "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv",
           "TransformerConv"]
