"""Datasets and the graph-batch loader."""

from .datasets import (LargeGraphData, NodeClassificationData,
                       TemporalBrainsData, TemporalSignalData, load_cora,
                       load_metrla, load_ogbn_products, load_temporalbrains,
                       metrla_from_files, mldataset_to_graph, ogbn_from_files,
                       planetoid_from_files, planetoid_from_raw,
                       synthetic_cora, synthetic_tudataset,
                       temporalbrains_from_files, tudataset_from_files)
from .loader import DataLoader

__all__ = ["NodeClassificationData", "synthetic_cora", "synthetic_tudataset",
           "mldataset_to_graph", "planetoid_from_files", "planetoid_from_raw",
           "tudataset_from_files", "load_cora", "LargeGraphData",
           "ogbn_from_files", "load_ogbn_products", "TemporalSignalData",
           "metrla_from_files", "load_metrla", "TemporalBrainsData",
           "temporalbrains_from_files", "load_temporalbrains", "DataLoader"]
