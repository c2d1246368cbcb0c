"""Layers and containers."""

from .basic import GNNChain, GNNLayer, WithGraph, glorot_uniform
from .conv import GATConv, GCNConv, GINConv, GraphConv, MLP, SAGEConv

__all__ = ["GNNChain", "GNNLayer", "WithGraph", "glorot_uniform", "GATConv",
           "GCNConv", "GINConv", "GraphConv", "MLP", "SAGEConv"]
