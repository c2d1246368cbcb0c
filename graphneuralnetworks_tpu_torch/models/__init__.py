"""Layers and containers."""

from .basic import GNNChain, GNNLayer, WithGraph, glorot_uniform
from .conv import (GATConv, GATv2Conv, GCNConv, GINConv, GraphConv, MLP,
                   SAGEConv)

__all__ = ["GNNChain", "GNNLayer", "WithGraph", "glorot_uniform", "GATConv",
           "GATv2Conv", "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv"]
