"""Layers and containers."""

from .basic import GNNChain, GNNLayer, WithGraph, glorot_uniform
from .conv import GCNConv, GINConv, GraphConv, MLP, SAGEConv

__all__ = ["GNNChain", "GNNLayer", "WithGraph", "glorot_uniform", "GCNConv",
           "GINConv", "GraphConv", "MLP", "SAGEConv"]
