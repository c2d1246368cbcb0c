"""Minibatches of whole graphs for graph-level tasks.

Counterpart of ``graphneuralnetworks_tpu/data/loader.py`` (reference: the
examples' ``DataLoader(...; batchsize, shuffle, collate=true)``, collated by
``MLUtils.batch``, transform.jl:671-713). The JAX loader sorts the graphs
into size-quantile buckets so that each bucket's batches share one padded
shape; the port keeps the buckets, their order and their draws, so that one
seed gives the same graphs in each batch, in the same order, as the JAX
package, but builds each batch at its true size with :func:`~.transform.
batch` and pads nothing.

As in the JAX package, a bucket's short last batch is filled up to
``batch_size`` with empty graphs (0 nodes, 0 edges, zero globals). They
count in ``num_graphs`` and so in a graph-level loss or accuracy over
``graph_mask``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..graph import GraphTuple, graph
from ..transform import batch as batch_graphs

__all__ = ["DataLoader"]


class DataLoader:
    """Iterate batches of ``batch_size`` graphs, built on ``device``
    (``None``: the CUDA card).

    The graphs, sorted by size (nodes + edges, stable), split into
    ``num_buckets`` buckets of equal count; every batch draws from one
    bucket. With ``shuffle=True`` the graphs shuffle within their bucket
    and the batches of all buckets are shuffled together, from
    ``np.random.default_rng(seed)``.
    """

    def __init__(self, graphs: Sequence[GraphTuple], *, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, num_buckets: int = 1,
                 device=None):
        self.graphs = list(graphs)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        if num_buckets < 1:
            raise ValueError("num_buckets must be >= 1")
        size = np.array([g.num_nodes + g.num_edges for g in self.graphs])
        order = np.argsort(size, kind="stable")
        self._buckets = [b for b in np.array_split(order, num_buckets)
                         if len(b)]

    def __len__(self):
        bs = self.batch_size
        return sum((len(b) + bs - 1) // bs for b in self._buckets)

    def _plan(self) -> list[np.ndarray]:
        """The next epoch's batches as graph indices (draws from the
        loader's generator, as iterating does)."""
        bs = self.batch_size
        plan = []
        for idxs in self._buckets:
            idxs = idxs.copy()
            if self.shuffle:
                self._rng.shuffle(idxs)
            plan += [idxs[i:i + bs] for i in range(0, len(idxs), bs)]
        if self.shuffle:
            self._rng.shuffle(plan)
        return plan

    def __iter__(self):
        for idxs in self._plan():
            chunk = [self.graphs[j] for j in idxs]
            chunk += [_empty_like(chunk[0])] * (self.batch_size - len(chunk))
            yield batch_graphs(chunk, device=self.device)


def _empty_like(g: GraphTuple) -> GraphTuple:
    """A graph of 0 nodes and 0 edges with ``g``'s feature schema and one
    row of zero globals, on the host (:func:`batch` reads it there)."""
    def zeros(feats, n):
        return {k: torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype)
                for k, v in feats.items()} or None
    return graph(np.zeros(0, np.int64), np.zeros(0, np.int64), num_nodes=0,
                 nodes=zeros(g.nodes, 0), edges=zeros(g.edges, 0),
                 globals_=zeros(g.globals_, 1), device="cpu")
