"""Datasets."""

from .datasets import (NodeClassificationData, load_cora,
                       planetoid_from_files, planetoid_from_raw,
                       synthetic_cora)

__all__ = ["NodeClassificationData", "load_cora", "planetoid_from_files",
           "planetoid_from_raw", "synthetic_cora"]
