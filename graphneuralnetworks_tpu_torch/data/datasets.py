"""Datasets: the Cora and MUTAG analogues, and readers of the real files.

Counterpart of ``graphneuralnetworks_tpu/data/datasets.py``: the synthetic
sets (``synthetic_cora``, ``synthetic_tudataset``), the adapter
``mldataset_to_graph`` (reference GNNGraphs mldatasets.jl:25-41) and the
readers of Planetoid, TUDataset, OGB node-property (``ogbn_from_files``),
METR-LA and TemporalBrains files, each with a ``load_*`` that searches the
usual places and returns ``(None, False)`` (Cora: the analogue) when the
files are absent. Nothing is downloaded. The data is built with numpy
exactly as there, so one seed or one file gives the same graphs, features,
labels and splits in both packages; graphs and masks are then placed on
``device`` (``None``: the CUDA card) at true size. ``LargeGraphData`` and
``TemporalSignalData`` keep host arrays, as in the JAX package (an
ogbn-scale edge list is for a sampler, :class:`~..sampling.NeighborLoader`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..graph import GraphTuple, graph

__all__ = ["NodeClassificationData", "synthetic_cora", "synthetic_tudataset",
           "mldataset_to_graph", "planetoid_from_files",
           "planetoid_from_raw", "tudataset_from_files", "load_cora",
           "LargeGraphData", "ogbn_from_files", "load_ogbn_products",
           "TemporalSignalData", "metrla_from_files", "load_metrla",
           "TemporalBrainsData", "temporalbrains_from_files",
           "load_temporalbrains"]


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


def synthetic_tudataset(num_graphs: int = 188, *, seed: int = 0,
                        min_nodes: int = 10, max_nodes: int = 28,
                        num_features: int = 7, device=None
                        ) -> tuple[list[GraphTuple], np.ndarray]:
    """MUTAG-analog binary graph-classification set: ``(graphs, labels)``.

    Each graph has one-hot "atom type" node features ``x`` and its label as
    ``globals_["y"]``. Positive graphs (about 2 in 3, as in MUTAG) hold a
    ring motif and a shifted type distribution; negatives are trees.
    """
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    graphs, labels = [], []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        label = int(rng.random() < 0.66)
        # a random spanning tree
        s_list, r_list = [], []
        for v in range(1, n):
            u = int(rng.integers(0, v))
            s_list += [u, v]
            r_list += [v, u]
        if label:
            # a ring over a random subset (the "motif")
            k = min(6, n)
            ring = rng.choice(n, k, replace=False)
            for a, b in zip(ring, np.roll(ring, 1)):
                s_list += [int(a), int(b)]
                r_list += [int(b), int(a)]
        probs = np.full(num_features, 1.0 / num_features)
        if label:
            probs = np.array([0.3, 0.3, 0.1, 0.1, 0.1, 0.05, 0.05])
            probs = probs[:num_features] / probs[:num_features].sum()
        types = rng.choice(num_features, n, p=probs)
        x = np.eye(num_features, dtype=np.float32)[types]
        graphs.append(graph(s_list, r_list, num_nodes=n, nodes={"x": x},
                            globals_={"y": np.asarray([label], np.int64)},
                            device=device))
        labels.append(label)
    return graphs, np.asarray(labels, np.int64)


def mldataset_to_graph(dataset, *, device=None) -> GraphTuple:
    """Duck-typed adapter from MLDatasets- or PyG-style graph objects
    (mldatasets.jl:25-41): reads ``num_nodes``, ``edge_index`` (a pair of
    index arrays), and ``node_data``/``edge_data`` dicts or ``x``, ``y``
    and ``edge_attr``; a dataset of one graph gives that graph."""
    obj = dataset
    if hasattr(obj, "graphs") and len(getattr(obj, "graphs")) == 1:
        obj = obj.graphs[0]
    ei = getattr(obj, "edge_index")
    nodes, edges = {}, {}
    nd = getattr(obj, "node_data", None)
    if nd is not None:
        nodes = {k: np.asarray(v) for k, v in dict(nd).items()}
    else:
        for k in ("x", "y"):
            v = getattr(obj, k, None)
            if v is not None:
                nodes[k] = np.asarray(v)
    ed = getattr(obj, "edge_data", None)
    if ed is not None:
        edges = {k: np.asarray(v) for k, v in dict(ed).items()}
    elif getattr(obj, "edge_attr", None) is not None:
        edges["e"] = np.asarray(obj.edge_attr)
    return graph(np.asarray(ei[0]), np.asarray(ei[1]),
                 num_nodes=int(getattr(obj, "num_nodes")),
                 nodes=nodes or None, edges=edges or None, device=device)


def _one_hot(lab: np.ndarray) -> np.ndarray:
    lab = lab[:, 0].astype(np.int64)
    lab -= lab.min()
    return np.eye(int(lab.max()) + 1, dtype=np.float32)[lab]


def tudataset_from_files(directory: str, name: str, *, device=None
                         ) -> tuple[list[GraphTuple], np.ndarray]:
    """Read the raw TUDataset format (``{name}_A.txt`` and the rest) into
    ``(graphs, labels)`` as :func:`synthetic_tudataset` returns them.

    Files (1-based ids): ``{name}_A.txt`` (edges ``i, j``),
    ``_graph_indicator.txt``, ``_graph_labels.txt`` (any integers, made
    0..C-1); optional ``_node_labels.txt`` (one-hot) and
    ``_node_attributes.txt`` (joined into ``x``), ``_edge_labels.txt`` and
    ``_edge_attributes.txt`` (into ``e``). The label rides as
    ``globals_["y"]``.
    """
    def path(suffix):
        return os.path.join(directory, f"{name}_{suffix}.txt")

    def optional(suffix):
        return (np.loadtxt(path(suffix), delimiter=",", ndmin=2)
                if os.path.exists(path(suffix)) else None)

    device = resolve_device(device)
    A = np.loadtxt(path("A"), delimiter=",", dtype=np.int64, ndmin=2)
    gi = np.loadtxt(path("graph_indicator"), dtype=np.int64) - 1
    glabels = np.loadtxt(path("graph_labels"))
    y = np.searchsorted(np.unique(glabels), glabels).astype(np.int64)

    def features(labels, attrs):
        parts = ([] if labels is None else [_one_hot(labels)]) + \
            ([] if attrs is None else [attrs.astype(np.float32)])
        return np.concatenate(parts, axis=1) if parts else None

    x = features(optional("node_labels"), optional("node_attributes"))
    efeat = features(optional("edge_labels"), optional("edge_attributes"))
    s_all, r_all = A[:, 0] - 1, A[:, 1] - 1
    num_graphs = int(gi.max()) + 1
    node_off = np.concatenate([[0], np.cumsum(np.bincount(
        gi, minlength=num_graphs))])
    e_graph = gi[s_all]
    graphs = []
    for k in range(num_graphs):
        nsel = slice(node_off[k], node_off[k + 1])
        esel = e_graph == k
        graphs.append(graph(
            s_all[esel] - node_off[k], r_all[esel] - node_off[k],
            num_nodes=int(node_off[k + 1] - node_off[k]),
            nodes=None if x is None else {"x": x[nsel]},
            edges=None if efeat is None else {"e": efeat[esel]},
            globals_={"y": y[k:k + 1]}, device=device))
    return graphs, y


@dataclasses.dataclass
class LargeGraphData:
    """A sampling-scale graph as host arrays (an ogbn edge list is for a
    sampler, which ships per-batch arrays to the card: ``NeighborLoader``,
    or ``sampling.in_csr`` then ``NeighborLoader.from_csr`` or
    ``DeviceSampler.build``)."""

    senders: np.ndarray      # int32[E]
    receivers: np.ndarray    # int32[E]
    num_nodes: int
    x: np.ndarray | None     # float32[N, D] node features
    y: np.ndarray | None     # int32[N] labels
    splits: dict             # name -> int64 node ids


def _open_maybe_gz(path):
    import gzip
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _find(directory, *names):
    """The first of ``names`` (or its ``.gz``) that exists in
    ``directory``, or None."""
    for n in names:
        for cand in (n, n + ".gz"):
            p = os.path.join(directory, cand)
            if os.path.exists(p):
                return p
    return None


def _loadtxt(path, **kw):
    with _open_maybe_gz(path) as f:
        return np.loadtxt(f, **kw)


def ogbn_from_files(directory: str) -> LargeGraphData:
    """Read an OGB node-property dataset (the ogbn-products layout).

    Either ``{dir}/ogbn.npz`` (``edge_index [2, E]``, ``node_feat``,
    ``node_label``, ``train_idx``/``valid_idx``/``test_idx``, optional
    ``num_nodes``) or the OGB tree: ``raw/edge.csv[.gz]`` ("src,dst"),
    ``raw/node-feat.csv[.gz]``, ``raw/node-label.csv[.gz]`` and
    ``split/*/{train,valid,test}.csv[.gz]``.
    """
    import glob

    npz = os.path.join(directory, "ogbn.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        ei = np.asarray(z["edge_index"], np.int32)
        splits = {k: np.asarray(z[f"{k}_idx"], np.int64)
                  for k in ("train", "valid", "test") if f"{k}_idx" in z}
        x = np.asarray(z["node_feat"], np.float32) \
            if "node_feat" in z else None
        y = np.asarray(z["node_label"], np.int32).reshape(-1) \
            if "node_label" in z else None
        n = int(z["num_nodes"]) if "num_nodes" in z else (
            x.shape[0] if x is not None else int(ei.max()) + 1)
        return LargeGraphData(ei[0], ei[1], n, x, y, splits)

    raw = os.path.join(directory, "raw")
    edge_p = _find(raw, "edge.csv") or _find(directory, "edge.csv")
    if edge_p is None:
        raise FileNotFoundError(
            f"no ogbn.npz and no raw/edge.csv under {directory}")
    base = os.path.dirname(edge_p)
    ei = _loadtxt(edge_p, delimiter=",", dtype=np.int64, ndmin=2)
    s, r = ei[:, 0].astype(np.int32), ei[:, 1].astype(np.int32)
    p = _find(base, "node-feat.csv")
    x = (_loadtxt(p, delimiter=",", dtype=np.float32, ndmin=2) if p
         else None)
    p = _find(base, "node-label.csv")
    y = (_loadtxt(p, delimiter=",", dtype=np.int64).reshape(-1)
         .astype(np.int32) if p else None)
    n = (x.shape[0] if x is not None
         else (y.shape[0] if y is not None
               else int(max(s.max(), r.max())) + 1))
    splits = {}
    for sp in glob.glob(os.path.join(directory, "split", "*")):
        for name in ("train", "valid", "test"):
            p = _find(sp, f"{name}.csv")
            if p:
                splits[name] = _loadtxt(p, dtype=np.int64).reshape(-1)
        if splits:
            break
    return LargeGraphData(s, r, n, x, y, splits)


def _search(env: str, name: str, reader):
    """``(reader(dir), True)`` for the first of ``$env``, ``./data/name``
    and ``~/.datasets/name`` that holds the files, else ``(None, False)``."""
    for c in (os.environ.get(env), os.path.join("data", name),
              os.path.expanduser(os.path.join("~", ".datasets", name))):
        if not c or not os.path.isdir(c):
            continue
        try:
            return reader(c), True
        except FileNotFoundError:
            continue
    return None, False


def load_ogbn_products() -> tuple[LargeGraphData | None, bool]:
    """The real ogbn-products when its files are on disk (in
    ``$GNN_OGBN_PRODUCTS_DIR``, ``./data/ogbn-products`` or
    ``~/.datasets/ogbn-products``): ``(data, True)``; else ``(None,
    False)``."""
    return _search("GNN_OGBN_PRODUCTS_DIR", "ogbn-products", ogbn_from_files)


@dataclasses.dataclass
class TemporalSignalData:
    """Traffic forecasting: one static sensor graph and a ``[T, N, C]``
    signal (reference consumer: examples/traffic_prediction_metrla.jl)."""

    senders: np.ndarray
    receivers: np.ndarray
    edge_weight: np.ndarray | None
    num_nodes: int
    signal: np.ndarray        # float32[T, N, C]
    timestamps: np.ndarray | None = None


def metrla_from_files(directory: str) -> TemporalSignalData:
    """Read METR-LA (or a dataset of the same layout).

    Either ``{dir}/metrla.npz`` (``signal [T, N]`` or ``[T, N, C]``, ``adj
    [N, N]``, optional ``timestamps``) or the distribution's
    ``metr-la.h5`` (pandas fixed format, read with h5py:
    ``df/block0_values`` and the ``df/axis1`` timestamps) with
    ``adj_mx.pkl`` (a pickle whose last element is the adjacency). h5py is
    imported only for the ``.h5`` files.
    """
    import pickle

    npz = os.path.join(directory, "metrla.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        sig = np.asarray(z["signal"], np.float32)
        adj = np.asarray(z["adj"], np.float32)
        ts = np.asarray(z["timestamps"]) if "timestamps" in z else None
    else:
        h5 = _find(directory, "metr-la.h5", "metr_la.h5", "pems-bay.h5")
        pkl = _find(directory, "adj_mx.pkl", "adj_mx_bay.pkl")
        if h5 is None or pkl is None:
            raise FileNotFoundError(
                f"no metrla.npz and no (metr-la.h5, adj_mx.pkl) under "
                f"{directory}")
        import h5py
        with h5py.File(h5, "r") as f:
            grp = f[next(iter(f.keys()))]          # pandas stores 'df'
            if hasattr(grp, "keys") and "block0_values" in grp:
                sig = np.asarray(grp["block0_values"], np.float32)
                ts = np.asarray(grp["axis1"]) if "axis1" in grp else None
            else:                                  # a plain dataset
                sig = np.asarray(grp, np.float32)
                ts = None
        with open(pkl, "rb") as f:
            obj = pickle.load(f, encoding="latin1")
        adj = np.asarray(obj[-1] if isinstance(obj, (tuple, list)) else obj,
                         np.float32)
    if sig.ndim == 2:
        sig = sig[:, :, None]
    n = adj.shape[0]
    if sig.shape[1] != n:
        raise ValueError(f"signal has {sig.shape[1]} sensors, adjacency "
                         f"has {n}")
    s, r = np.nonzero(adj)
    return TemporalSignalData(s.astype(np.int32), r.astype(np.int32),
                              adj[s, r].astype(np.float32), n, sig, ts)


def load_metrla() -> tuple[TemporalSignalData | None, bool]:
    """The real METR-LA when its files are on disk (``$GNN_METRLA_DIR``,
    ``./data/metr-la``, ``~/.datasets/metr-la``), else ``(None,
    False)``."""
    return _search("GNN_METRLA_DIR", "metr-la", metrla_from_files)


@dataclasses.dataclass
class TemporalBrainsData:
    """TemporalBrains (fMRI temporal brain graphs; reference consumer:
    examples/graph_classification_temporalbrains.jl): S subjects x T
    snapshots over the same N regions, each snapshot's node activity, and a
    binary label (0 = F, 1 = M), as host arrays."""

    activity: np.ndarray        # float32 [S, T, N]
    labels: np.ndarray          # int32 [S]
    edge_ptr: np.ndarray        # int64 [S*T + 1] into senders/receivers
    senders: np.ndarray         # int32 [total_edges]
    receivers: np.ndarray       # int32 [total_edges]

    @property
    def num_subjects(self) -> int:
        return self.activity.shape[0]

    @property
    def num_snapshots(self) -> int:
        return self.activity.shape[1]

    def subject(self, i: int, *, identity_features: bool = True,
                device=None):
        """Subject ``i`` as a :class:`~..temporal.TemporalGraph` of one node
        count, with the reference's features ``x_t = [I(N) | activity_t]``
        (temporalbrains.jl:28-30) and its label as ``tgdata["y"]``. The
        snapshots keep their true edge counts (JAX's pads them to the
        dataset's largest); ``TemporalGraph.from_snapshots(g.snapshots,
        uniform=True)`` pads them to one."""
        from ..temporal import TemporalGraph

        device = resolve_device(device)
        _, t_dim, n = self.activity.shape
        eye = np.eye(n, dtype=np.float32)
        snaps = []
        for t in range(t_dim):
            lo, hi = self.edge_ptr[i * t_dim + t: i * t_dim + t + 2]
            sig = self.activity[i, t].astype(np.float32)[:, None]
            x = np.concatenate([eye, sig], axis=1) if identity_features \
                else sig
            snaps.append(graph(self.senders[lo:hi], self.receivers[lo:hi],
                               num_nodes=n, nodes={"x": x}, device=device))
        return TemporalGraph.from_snapshots(
            snaps,
            tgdata={"y": torch.tensor(int(self.labels[i]), device=device)})


def temporalbrains_from_files(directory: str) -> TemporalBrainsData:
    """Read a TemporalBrains dump: ``{dir}/temporalbrains.npz``
    (``activity [S, T, N]``, ``labels [S]`` as ints or 'F'/'M',
    ``edge_ptr [S*T + 1]``, ``senders``, ``receivers``) or the split files
    ``activity.npy``, ``labels.npy`` and ``edges.npz``."""
    npz = os.path.join(directory, "temporalbrains.npz")
    if os.path.exists(npz):
        z = np.load(npz, allow_pickle=False)
        act, lab = z["activity"], z["labels"]
    else:
        a_p, l_p, e_p = (os.path.join(directory, f) for f in (
            "activity.npy", "labels.npy", "edges.npz"))
        if not all(os.path.exists(p) for p in (a_p, l_p, e_p)):
            raise FileNotFoundError(
                f"no temporalbrains.npz and no (activity.npy, labels.npy, "
                f"edges.npz) under {directory}")
        act, lab = np.load(a_p), np.load(l_p)
        z = np.load(e_p)
    ptr, s, r = z["edge_ptr"], z["senders"], z["receivers"]
    if lab.dtype.kind in "US":        # 'F'/'M' strings -> 0/1
        lab = (np.char.upper(lab.astype(str)) == "M").astype(np.int32)
    st = act.shape[0] * act.shape[1]
    if ptr.shape[0] != st + 1:
        raise ValueError(f"edge_ptr has {ptr.shape[0]} entries, expected "
                         f"S*T+1 = {st + 1}")
    return TemporalBrainsData(
        activity=np.asarray(act, np.float32),
        labels=np.asarray(lab, np.int32).reshape(-1),
        edge_ptr=np.asarray(ptr, np.int64),
        senders=np.asarray(s, np.int32),
        receivers=np.asarray(r, np.int32))


def load_temporalbrains() -> tuple[TemporalBrainsData | None, bool]:
    """The real TemporalBrains when its files are on disk
    (``$GNN_TEMPORALBRAINS_DIR``, ``./data/temporalbrains``,
    ``~/.datasets/temporalbrains``), else ``(None, False)``."""
    return _search("GNN_TEMPORALBRAINS_DIR", "temporalbrains",
                   temporalbrains_from_files)
