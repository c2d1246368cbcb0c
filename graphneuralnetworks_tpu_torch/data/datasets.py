"""Node-classification data: the Cora analogue and the real Cora files.

Counterpart of ``graphneuralnetworks_tpu/data/datasets.py``
(``synthetic_cora``, ``load_cora`` and the Planetoid readers). The data is
built with numpy exactly as there, so one seed gives the same graph,
features and splits in both packages; the graph and the masks are then
placed on ``device`` (``None``: the CUDA card) at true size.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..graph import GraphTuple, graph

__all__ = ["NodeClassificationData", "synthetic_cora", "planetoid_from_raw",
           "planetoid_from_files", "load_cora"]


@dataclasses.dataclass
class NodeClassificationData:
    graph: GraphTuple
    num_classes: int
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    test_mask: torch.Tensor


def _data(s, r, x, y, num_classes, masks, device) -> NodeClassificationData:
    device = resolve_device(device)
    g = graph(s, r, num_nodes=x.shape[0],
              nodes={"x": x.astype(np.float32), "y": y.astype(np.int64)},
              device=device)
    return NodeClassificationData(
        g, int(num_classes),
        *(torch.as_tensor(np.asarray(m, bool), device=device)
          for m in masks))


def synthetic_cora(*, seed: int = 0, num_nodes: int = 2708,
                   num_classes: int = 7, num_features: int = 1433,
                   avg_degree: float = 3.9, homophily: float = 0.81,
                   device=None) -> NodeClassificationData:
    """Cora-analog citation graph: a 7-class stochastic block model with
    class-correlated sparse bag-of-words features and Planetoid splits
    (140 train / 500 val / 1000 test)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)

    # edges: a homophilous configuration-like model
    m = int(avg_degree * num_nodes / 2)
    src = rng.integers(0, num_nodes, 4 * m)
    dst = rng.integers(0, num_nodes, 4 * m)
    same = y[src] == y[dst]
    keep_p = np.where(same, 1.0, (1 - homophily) / max(homophily, 1e-9)
                      / (num_classes - 1))
    keep = rng.random(4 * m) < keep_p
    src, dst = src[keep], dst[keep]
    order = rng.permutation(len(src))[:m]
    src, dst = src[order], dst[order]
    ok = src != dst
    src, dst = src[ok], dst[ok]
    s = np.concatenate([src, dst])
    r = np.concatenate([dst, src])

    # features: class-prototype sparse bag of words
    words_per_class = num_features // num_classes
    x = np.zeros((num_nodes, num_features), np.float32)
    n_words = 18  # about Cora's nonzeros per row
    for i in range(num_nodes):
        # 70% of the words from the class block, 30% anywhere
        k_cls = int(n_words * 0.7)
        lo = y[i] * words_per_class
        wc = rng.integers(lo, lo + words_per_class, k_cls)
        wr = rng.integers(0, num_features, n_words - k_cls)
        x[i, np.concatenate([wc, wr])] = 1.0
    x /= np.maximum(x.sum(1, keepdims=True), 1)  # Planetoid row-normalization

    # Planetoid splits
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    perm = rng.permutation(num_nodes)
    per_class = 20
    count = {c: 0 for c in range(num_classes)}
    for i in perm:
        c = int(y[i])
        if count[c] < per_class:
            train_mask[i] = True
            count[c] = count[c] + 1
    rest = perm[~train_mask[perm]]
    val_mask[rest[:500]] = True
    test_mask[rest[500:1500]] = True
    return _data(s, r, x, y, num_classes, (train_mask, val_mask, test_mask),
                 device)


def planetoid_from_raw(directory: str, name: str = "cora", *,
                       device=None) -> NodeClassificationData:
    """Load the real Planetoid raw pickles (``ind.cora.x`` ...
    ``ind.cora.test.index``) with the canonical Planetoid assembly."""
    import pickle

    def _load(suffix):
        with open(os.path.join(directory, f"ind.{name}.{suffix}"),
                  "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = _load("x"), _load("tx"), _load("allx")
    y, ty, ally = _load("y"), _load("ty"), _load("ally")
    graph_dict = _load("graph")
    test_idx = np.loadtxt(
        os.path.join(directory, f"ind.{name}.test.index"), dtype=np.int64)

    def _dense(a):
        return np.asarray(a.todense() if hasattr(a, "todense") else a,
                          np.float32)

    allx, tx = _dense(allx), _dense(tx)
    ty = np.asarray(ty, np.float32)
    test_sorted = np.sort(test_idx)
    if name == "citeseer":
        # gaps in the test index range: zero rows for the isolated nodes
        full = np.arange(test_sorted.min(), test_sorted.max() + 1)
        tx_full = np.zeros((len(full), tx.shape[1]), np.float32)
        tx_full[test_sorted - test_sorted.min()] = tx
        ty_full = np.zeros((len(full), ty.shape[1]), np.float32)
        ty_full[test_sorted - test_sorted.min()] = ty
        tx, ty = tx_full, ty_full

    feats = np.vstack([allx, tx])
    labels_oh = np.vstack([np.asarray(ally, np.float32), ty])
    feats[test_idx] = feats[test_sorted]
    labels_oh[test_idx] = labels_oh[test_sorted]
    labels = labels_oh.argmax(1)
    num_nodes = feats.shape[0]

    s_list, r_list = [], []
    for u, nbrs in graph_dict.items():
        for v in nbrs:
            if u < num_nodes and v < num_nodes:
                s_list.append(u)
                r_list.append(v)
    s = np.asarray(s_list, np.int64)
    r = np.asarray(r_list, np.int64)
    # symmetrize, deduplicate, drop self-loops
    key = np.unique(np.concatenate([s * num_nodes + r, r * num_nodes + s]))
    s2, r2 = key // num_nodes, key % num_nodes
    keep = s2 != r2
    s2, r2 = s2[keep], r2[keep]

    feats /= np.maximum(feats.sum(1, keepdims=True), 1)

    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    ntrain = np.asarray(y).shape[0]
    train_mask[:ntrain] = True
    val_mask[ntrain:ntrain + 500] = True
    test_mask[test_idx] = True
    return _data(s2, r2, feats, labels, labels.max() + 1,
                 (train_mask, val_mask, test_mask), device)


def planetoid_from_files(path: str, *, device=None) -> NodeClassificationData:
    """Load a Planetoid-style ``.npz`` (x, y, edge_index, masks)."""
    z = np.load(path)
    s, r = z["edge_index"]
    return _data(s, r, z["x"], z["y"], z["y"].max() + 1,
                 (z["train_mask"], z["val_mask"], z["test_mask"]), device)


def load_cora(*, seed: int = 0, device=None
              ) -> tuple[NodeClassificationData, bool]:
    """The real Cora when its files are on disk, else the synthetic analogue.

    Looks in ``$GNN_CORA_DIR``, ``./data/cora`` and ``~/.datasets/cora`` for
    the raw Planetoid pickles, then for a ``cora.npz``. Returns
    ``(data, is_real)``.
    """
    candidates = [os.environ.get("GNN_CORA_DIR"), "data/cora",
                  os.path.expanduser("~/.datasets/cora")]
    for c in candidates:
        if c and os.path.exists(os.path.join(c, "ind.cora.graph")):
            return planetoid_from_raw(c, "cora", device=device), True
        if c and os.path.exists(os.path.join(c, "cora.npz")):
            return planetoid_from_files(os.path.join(c, "cora.npz"),
                                        device=device), True
    return synthetic_cora(seed=seed, device=device), False
