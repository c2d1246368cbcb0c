"""Graph transforms: self-loops, edge and node surgery, batching, sampling
splits, positional encodings.

Counterpart of ``graphneuralnetworks_tpu/transform.py`` (reference
GNNGraphs transform.jl). A transform that changes the edge or node count
is host surgery, as there: the graph's edges are read in their stored
order (receiver-sorted, stable, in both packages), changed with numpy and
rebuilt by :func:`~.graph.graph` on the input graph's device, at true size.
A function that draws takes a ``np.random.Generator`` and makes the same
draws in the same order as the JAX package, so one seed gives the same
graph in both. ``negative_sample``, its bidirected test and
``rand_edge_split``, which the JAX package writes as Python loops over
sets and dicts, are vectorised here with the same output bit for bit (they
run once a training step in link prediction, on millions of edges).

``batch`` places the batch on ``device`` (``None``: the CUDA card). The JAX
package's padding arguments (``n_pad``, ``e_pad`` of ``blockdiag``,
``batch`` and ``getgraph``) have no counterpart: nothing is padded.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

from .graph import GraphTuple, graph, no_edge_valid
from .utils import _host

__all__ = ["add_self_loops", "remove_self_loops", "remove_edges",
           "remove_multi_edges", "remove_nodes", "add_edges", "add_nodes",
           "perturb_edges", "set_edge_weight", "to_bidirected",
           "to_unidirected", "blockdiag", "batch", "unbatch", "getgraph",
           "negative_sample", "rand_edge_split", "random_walk_pe",
           "ppr_diffusion", "sort_edge_index"]


# ---------------------------------------------------------------------------
# host unpacking (JAX transform.py:63-114)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Host:
    s: np.ndarray
    r: np.ndarray
    w: np.ndarray | None
    nn: int
    ne: int
    ng: int
    nodes: dict
    edges: dict
    globals_: dict
    gid: np.ndarray
    device: torch.device


def _coo(g: GraphTuple) -> tuple[np.ndarray, np.ndarray]:
    """``g``'s senders and receivers on the host, in stored order. Refuses a
    graph with ``edge_valid``: its invalid edges would count as real."""
    if g.edge_valid is not None:
        raise ValueError(
            "host transforms do not support graphs with edge_valid "
            "(device-sampled batches); transform the source graph instead")
    return _host(g.senders), _host(g.receivers)


def _unpack(g: GraphTuple) -> _Host:
    s, r = _coo(g)
    return _Host(
        s=s, r=r, w=None if g.edge_weight is None else _host(g.edge_weight),
        nn=g.num_nodes, ne=g.num_edges, ng=g.num_graphs,
        nodes={k: _host(v) for k, v in g.nodes.items()},
        edges={k: _host(v) for k, v in g.edges.items()},
        globals_={k: _host(v) for k, v in g.globals_.items()},
        gid=_host(g.node_graph_id), device=g.device)


def _repack(h: _Host) -> GraphTuple:
    return graph(h.s, h.r, num_nodes=h.nn, nodes=h.nodes or None,
                 edges=h.edges or None, globals_=h.globals_ or None,
                 edge_weight=h.w, node_graph_id=h.gid, num_graphs=h.ng,
                 device=h.device)


def _select_edges(h: _Host, keep: np.ndarray) -> _Host:
    """``h`` with only the edges ``keep`` (a mask or an index order)."""
    s = h.s[keep]
    return dataclasses.replace(
        h, s=s, r=h.r[keep], w=None if h.w is None else h.w[keep],
        edges={k: v[keep] for k, v in h.edges.items()}, ne=int(s.shape[0]))


# ---------------------------------------------------------------------------
# edge surgery (transform.jl)
# ---------------------------------------------------------------------------

def add_self_loops(g: GraphTuple, *, fill_weight: float = 1.0) -> GraphTuple:
    """Add ``i -> i`` for every node (transform.jl:12-39). Existing loops
    stay (a node that has one gets two); new loops weigh ``fill_weight`` on
    a weighted graph; a graph with edge features raises, as in the JAX
    package."""
    h = _unpack(g)
    if h.edges:
        raise ValueError("add_self_loops on a graph with edge features "
                         "(reference semantics: unsupported)")
    loops = np.arange(h.nn, dtype=h.s.dtype)
    h.s = np.concatenate([h.s, loops])
    h.r = np.concatenate([h.r, loops])
    if h.w is not None:
        h.w = np.concatenate([h.w, np.full(h.nn, fill_weight, h.w.dtype)])
    h.ne += h.nn
    return _repack(h)


def remove_self_loops(g: GraphTuple) -> GraphTuple:
    """transform.jl:49-78."""
    h = _unpack(g)
    return _repack(_select_edges(h, h.s != h.r))


def remove_edges(g: GraphTuple, edges_to_remove=None, *,
                 p: float | None = None,
                 rng: np.random.Generator | None = None) -> GraphTuple:
    """Remove edges by index (in stored order) or each with probability
    ``p`` (transform.jl:121-146)."""
    h = _unpack(g)
    if p is not None:
        rng = rng or np.random.default_rng()
        keep = rng.random(h.ne) >= p
    else:
        keep = np.ones(h.ne, dtype=bool)
        keep[_host(edges_to_remove).astype(np.int64)] = False
    return _repack(_select_edges(h, keep))


def remove_multi_edges(g: GraphTuple, *, aggr: str = "sum") -> GraphTuple:
    """Merge parallel edges, aggregating weights and features with ``aggr``
    in {sum, mean, max, min, first} (transform.jl:157-185). Sums run in
    int64 or float64 and are cast back; an integer mean is rounded."""
    h = _unpack(g)
    key = h.s.astype(np.int64) * h.nn + h.r
    uniq, first_idx, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
    inv = inv.reshape(-1)

    def agg(v):
        if aggr == "first":
            return v[first_idx]
        if aggr in ("max", "min"):
            # seeded with each edge's first copy: exact for every dtype
            out = v[first_idx].copy()
            (np.maximum if aggr == "max" else np.minimum).at(out, inv, v)
            return out
        if aggr not in ("sum", "mean"):
            raise ValueError(f"unknown aggr {aggr!r}")
        is_int = v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer)
        acc = np.zeros((len(uniq),) + v.shape[1:],
                       dtype=np.int64 if is_int else np.float64)
        np.add.at(acc, inv, v)
        if aggr == "mean":
            cnt = np.bincount(inv, minlength=len(uniq))
            accf = acc / cnt.reshape((-1,) + (1,) * (v.ndim - 1))
            return (np.rint(accf) if is_int else accf).astype(v.dtype)
        return acc.astype(v.dtype)

    h.edges = {k: agg(v) for k, v in h.edges.items()}
    if h.w is not None:
        h.w = agg(h.w)
    h.s, h.r = h.s[first_idx], h.r[first_idx]
    h.ne = len(uniq)
    return _repack(h)


def remove_nodes(g: GraphTuple, nodes_to_remove) -> GraphTuple:
    """Drop nodes and their edges, and number the rest in order
    (transform.jl:212-276)."""
    h = _unpack(g)
    keep_nodes = np.ones(h.nn, dtype=bool)
    keep_nodes[_host(nodes_to_remove).astype(np.int64)] = False
    remap = np.cumsum(keep_nodes) - 1  # old id -> new id
    h = _select_edges(h, keep_nodes[h.s] & keep_nodes[h.r])
    h.s, h.r = remap[h.s], remap[h.r]
    h.nodes = {k: v[keep_nodes] for k, v in h.nodes.items()}
    h.gid = h.gid[keep_nodes]
    h.nn = int(keep_nodes.sum())
    return _repack(h)


def add_edges(g: GraphTuple, senders, receivers, *, edges=None,
              edge_weight=None) -> GraphTuple:
    """Append edges, with their features and weights (transform.jl:319-353).

    Ids past the node count add nodes, in the last graph. If only one side
    has weights, the other side's are ones (utils.jl:48-122
    ``cat_features``).
    """
    h = _unpack(g)
    s2 = _host(senders).astype(np.int64).reshape(-1)
    r2 = _host(receivers).astype(np.int64).reshape(-1)
    ne2 = len(s2)
    h.nn = max(h.nn, int(max(s2.max(initial=-1), r2.max(initial=-1))) + 1)
    if len(h.gid) < h.nn:
        h.gid = np.pad(h.gid, (0, h.nn - len(h.gid)),
                       constant_values=h.ng - 1)
    h.s = np.concatenate([h.s, s2])
    h.r = np.concatenate([h.r, r2])
    w2 = None if edge_weight is None else _host(edge_weight).reshape(-1)
    if h.w is not None or w2 is not None:
        a = h.w if h.w is not None else np.ones(h.ne, np.float32)
        b = w2 if w2 is not None else np.ones(ne2, np.float32)
        h.w = np.concatenate([a, b])
    if edges is not None or h.edges:
        if edges is not None and not isinstance(edges, dict):
            edges = {"e": edges}
        newe = {k: _host(v) for k, v in (edges or {}).items()}
        if set(newe) != set(h.edges) and h.ne and ne2:
            raise ValueError("edge feature keys mismatch in add_edges")
        h.edges = {k: np.concatenate([h.edges[k], newe[k]]) if h.ne
                   else newe[k] for k in (newe or h.edges)}
    h.ne += ne2
    return _repack(h)


def add_nodes(g: GraphTuple, n: int, *, nodes=None) -> GraphTuple:
    """Append ``n`` isolated nodes, in the last graph (transform.jl:553-561);
    a feature not given for them is zeros."""
    h = _unpack(g)
    if nodes is not None and not isinstance(nodes, dict):
        nodes = {"x": nodes}
    newf = {k: _host(v) for k, v in (nodes or {}).items()}
    for k in newf:
        if k not in h.nodes:
            raise ValueError(f"new node feature {k!r} absent on old nodes")
    for k, v in h.nodes.items():
        h.nodes[k] = np.concatenate(
            [v, newf[k] if k in newf else np.zeros((n,) + v.shape[1:],
                                                   v.dtype)])
    h.gid = np.concatenate([h.gid, np.full(n, h.ng - 1, h.gid.dtype)])
    h.nn += n
    return _repack(h)


def perturb_edges(g: GraphTuple, perturb_ratio: float, *,
                  rng: np.random.Generator | None = None) -> GraphTuple:
    """Add ``ceil(ratio * E)`` random edges (transform.jl:385-420)."""
    rng = rng or np.random.default_rng()
    n_new = int(np.ceil(perturb_ratio * g.num_edges))
    s2 = rng.integers(0, g.num_nodes, n_new)
    r2 = rng.integers(0, g.num_nodes, n_new)
    return add_edges(g, s2, r2)


def set_edge_weight(g: GraphTuple, w) -> GraphTuple:
    """transform.jl:568-577."""
    h = _unpack(g)
    w = _host(w).reshape(-1)
    if w.shape[0] != h.ne:
        raise ValueError("edge weight length mismatch")
    h.w = w
    return _repack(h)


def to_bidirected(g: GraphTuple) -> GraphTuple:
    """Add the reverse edges, then keep the first copy of each
    (transform.jl:495-520)."""
    h = _unpack(g)
    g2 = add_edges(g, h.r, h.s, edges=h.edges or None, edge_weight=h.w)
    return remove_multi_edges(g2, aggr="first")


def to_unidirected(g: GraphTuple) -> GraphTuple:
    """Turn every edge to ``min -> max``, then keep the first copy of each
    (transform.jl:522-529)."""
    h = _unpack(g)
    h.s, h.r = np.minimum(h.s, h.r), np.maximum(h.s, h.r)
    return remove_multi_edges(_repack(h), aggr="first")


def sort_edge_index(g: GraphTuple) -> GraphTuple:
    """Sort the edges by sender, then receiver (utils.jl:41-45), and
    rebuild, which groups them by receiver again (stable)."""
    h = _unpack(g)
    return _repack(_select_edges(h, np.lexsort((h.r, h.s))))


# ---------------------------------------------------------------------------
# batching (transform.jl:579-876)
# ---------------------------------------------------------------------------

def _cat(dicts, sizes) -> dict:
    """Concatenate feature dicts; a key missing from a graph gives zeros of
    the other graphs' trailing shape and dtype."""
    keys = sorted(set().union(*dicts))
    out = {}
    for k in keys:
        proto = next(d[k] for d in dicts if k in d)
        out[k] = np.concatenate([
            d[k] if k in d else np.zeros((n,) + proto.shape[1:], proto.dtype)
            for d, n in zip(dicts, sizes)])
    return out


def batch(graphs: Sequence[GraphTuple], *, device=None) -> GraphTuple:
    """Batch graphs into one block-diagonal graph: node ids offset by the
    running node count, features concatenated, ``node_graph_id`` the
    position of each node's graph, ``num_graphs = len(graphs)`` (graphs of
    0 nodes count). ``device=None`` places the batch on the CUDA card."""
    if not graphs:
        raise ValueError("batch needs at least one graph")
    for g in graphs:
        no_edge_valid(g, "batch")
    sizes_n = [g.num_nodes for g in graphs]
    sizes_e = [g.num_edges for g in graphs]
    off = np.cumsum([0] + sizes_n)
    s = np.concatenate([_host(g.senders) + off[i]
                        for i, g in enumerate(graphs)])
    r = np.concatenate([_host(g.receivers) + off[i]
                        for i, g in enumerate(graphs)])
    gid = np.concatenate([np.full(n, i, np.int64)
                          for i, n in enumerate(sizes_n)])
    w = None
    if any(g.edge_weight is not None for g in graphs):
        w = np.concatenate([
            _host(g.edge_weight) if g.edge_weight is not None
            else np.ones(n, np.float32) for g, n in zip(graphs, sizes_e)])

    def feats(what, sizes):
        return _cat([{k: _host(v) for k, v in getattr(g, what).items()}
                     for g in graphs], sizes) or None

    return graph(s, r, num_nodes=int(off[-1]), nodes=feats("nodes", sizes_n),
                 edges=feats("edges", sizes_e),
                 globals_=feats("globals_", [g.num_graphs for g in graphs]),
                 edge_weight=w, node_graph_id=gid, num_graphs=len(graphs),
                 device=device)


def blockdiag(*graphs: GraphTuple, device=None) -> GraphTuple:
    """Disjoint union of graphs: :func:`batch` (transform.jl:579-628)."""
    return batch(list(graphs), device=device)


def unbatch(g: GraphTuple) -> list[GraphTuple]:
    """Split a batch back into its graphs (transform.jl:741-782)."""
    return [getgraph(g, i) for i in range(g.num_graphs)]


def getgraph(g: GraphTuple, i: int | Sequence[int]) -> GraphTuple:
    """The graph ``i`` of a batch, or the graphs of the ids ``i`` as one
    batch: nodes keep their order, graph ids follow the list's order
    (transform.jl:825-876)."""
    ids = np.atleast_1d(_host(i).astype(np.int64))
    h = _unpack(g)
    keep_nodes = np.isin(h.gid, ids)
    node_ids = np.nonzero(keep_nodes)[0]
    remap = -np.ones(h.nn, np.int64)
    remap[node_ids] = np.arange(len(node_ids))
    h = _select_edges(h, keep_nodes[h.s] & keep_nodes[h.r])
    h.s, h.r = remap[h.s], remap[h.r]
    h.nodes = {k: v[keep_nodes] for k, v in h.nodes.items()}
    gid_remap = -np.ones(h.ng, np.int64)
    gid_remap[ids] = np.arange(len(ids))
    h.gid = gid_remap[h.gid[keep_nodes]]
    h.globals_ = {k: v[ids] for k, v in h.globals_.items()}
    h.nn, h.ng = len(node_ids), len(ids)
    return _repack(h)


# ---------------------------------------------------------------------------
# sampling transforms (host side, as in the reference)
# ---------------------------------------------------------------------------

def _in_sorted(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Whether each of ``keys`` is in the sorted unique array ``table``
    (fastest when ``keys`` are sorted too: the searches then walk the table
    in order)."""
    if not len(table):
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(table, keys)
    return table[np.minimum(pos, len(table) - 1)] == keys


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of an integer array by a sort: numpy 2.3's
    ``np.unique`` hashes integers, which took 1.4-1.7 s for 1.8M keys on an
    8-core host where the sort takes tens of ms."""
    a = np.sort(a)
    return a[np.r_[True, a[1:] != a[:-1]]] if a.size else a


def _edge_keys(s: np.ndarray, r: np.ndarray, n: int):
    """The sorted unique keys ``s * n + r`` of the edges and whether every
    edge's reverse is an edge (JAX ``_is_bidirected_np``): the reverse keys
    make the same set."""
    s, r = s.astype(np.int64), r.astype(np.int64)
    keys = _sorted_unique(s * n + r)
    return keys, bool(np.array_equal(keys, _sorted_unique(r * n + s)))


def _is_bidirected_np(s: np.ndarray, r: np.ndarray, n: int) -> bool:
    return _edge_keys(s, r, n)[1]


def _first_draws(key: np.ndarray):
    """The sorted unique values of ``key`` and the position of each one's
    first occurrence (``np.unique(key, return_index=True)``, by an unstable
    sort and a minimum over each run of equal keys: three times faster)."""
    order = np.argsort(key)
    ks = key[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return ks[start], np.minimum.reduceat(order, start)


def _negative_edges(g: GraphTuple, num_neg_edges: int | None,
                    bidirected: bool | None, rng: np.random.Generator):
    """:func:`negative_sample`'s draw on the host: ``(senders,
    receivers)``, int64, in the JAX package's order.

    The JAX package draws rounds of ``max(2 * need, 32)`` candidate pairs
    and walks each in order, taking a pair that is not an edge (either way
    round, when bidirected), not a self-loop and not taken before, until it
    has ``target``. One round here takes the same pairs at once: the first
    draw of each acceptable key, in draw order, cut at ``need``. Whether a
    key is acceptable depends on the key alone, so the round's sorted
    unique keys are tested (sorted searches), each with its first draw.
    """
    s, r = _coo(g)
    n = g.num_nodes
    want = num_neg_edges if num_neg_edges is not None else g.num_edges
    keys, is_bidirected = _edge_keys(s, r, n)
    if bidirected is None:
        bidirected = is_bidirected
    if bidirected:
        # canonical (lo, hi) keys of the edges, either direction: on a
        # bidirected graph the keys with s <= r, already sorted
        blocked = (keys[keys // n <= keys % n] if is_bidirected else
                   _sorted_unique(np.minimum(s, r).astype(np.int64) * n
                                  + np.maximum(s, r)))
        target = min(want // 2, n * (n - 1) // 2
                     - int((blocked // n != blocked % n).sum()))
    else:
        blocked = keys
        target = min(want, n * n - n   # self-loops are excluded
                     - int((blocked // n != blocked % n).sum()))
    if target < (want // 2 if bidirected else want):
        warnings.warn(
            f"negative_sample: only {target * (2 if bidirected else 1)} "
            f"non-edges exist; requested {want}", stacklevel=3)
    taken = np.zeros(0, np.int64)            # sorted keys taken so far
    out = []
    got = 0
    while got < target:
        need = target - got
        a, b = rng.integers(0, n, (2, max(2 * need, 32)))
        key = (np.minimum(a, b) * n + np.maximum(a, b) if bidirected
               else a * n + b)
        uk, first = _first_draws(key)
        # a self-loop's key is i * n + i = i * (n + 1), either encoding
        ok = (uk % (n + 1) != 0) & ~_in_sorted(uk, blocked) \
            & ~_in_sorted(uk, taken)
        uk, first = uk[ok], first[ok]
        if len(first) > need:   # the need earliest draws
            keep = first <= np.partition(first, need - 1)[need - 1]
            uk, first = uk[keep], first[keep]
        out.append(key[np.sort(first)])
        taken = _sorted_unique(np.concatenate([taken, uk]))
        got += len(uk)
    key = np.concatenate(out) if out else np.zeros(0, np.int64)
    s, r = key // n, key % n
    if bidirected:   # mirror: [s; t], [t; s] (transform.jl:925-927)
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    return s, r


def negative_sample(g: GraphTuple, *, num_neg_edges: int | None = None,
                    bidirected: bool | None = None,
                    rng: np.random.Generator | None = None) -> GraphTuple:
    """Sample non-edges (transform.jl:891-929), on the host, as in the
    reference; the graph is built on ``g``'s device.

    Bidirected (by default, when every edge's reverse is an edge): half the
    request in unordered pairs that are no edge either way, each stored both
    ways, so that no reverse pair leaks. When fewer non-edges exist than
    requested, all of them come back with a warning. The same
    ``np.random.Generator`` state gives the JAX package's edges.
    """
    s, r = _negative_edges(g, num_neg_edges, bidirected,
                           rng or np.random.default_rng())
    return graph(s, r, num_nodes=g.num_nodes, device=g.device)


def rand_edge_split(g: GraphTuple, frac: float, *,
                    bidirected: bool | None = None,
                    rng: np.random.Generator | None = None
                    ) -> tuple[GraphTuple, GraphTuple]:
    """Split the edges into two graphs, ``frac`` of them in the first;
    bidirected, the pairs stay together (transform.jl:945-968).

    Bidirected: a permutation of the edges with ``s <= r`` picks
    ``round(frac * count)`` of them, and each pick brings the edge of its
    reverse key. Where a key repeats, that is the key's last edge (the JAX
    package's dict of keys keeps the last), so a self-loop's pick may bring
    another copy of itself.
    """
    rng = rng or np.random.default_rng()
    h = _unpack(g)
    if bidirected is None:
        bidirected = _is_bidirected_np(h.s, h.r, h.nn)
    if bidirected:
        idx = np.nonzero(h.s <= h.r)[0]
        perm = rng.permutation(len(idx))
        n1 = int(round(frac * len(idx)))
        chosen = idx[perm[:n1]]
        keep1 = np.zeros(h.ne, bool)
        keep1[chosen] = True
        # each key's last edge: its first in the reversed edge order
        key = h.s.astype(np.int64) * h.nn + h.r
        table, first_rev = _first_draws(key[::-1])
        # sorted, so that the searches walk the table in order
        rev = np.sort(h.r[chosen].astype(np.int64) * h.nn + h.s[chosen])
        rev = rev[_in_sorted(rev, table)]
        keep1[h.ne - 1 - first_rev[np.searchsorted(table, rev)]] = True
    else:
        perm = rng.permutation(h.ne)
        n1 = int(round(frac * h.ne))
        keep1 = np.zeros(h.ne, bool)
        keep1[perm[:n1]] = True
    return _repack(_select_edges(h, keep1)), _repack(_select_edges(h, ~keep1))


# ---------------------------------------------------------------------------
# positional encodings and diffusion (transform.jl:975-1051)
# ---------------------------------------------------------------------------

def random_walk_pe(g: GraphTuple, walk_length: int) -> torch.Tensor:
    """Random-walk positional encoding ``[N, walk_length]``: ``diag(P^k)``
    for ``k = 1..walk_length``, ``P = D_out^-1 A`` (transform.jl:975-990),
    dense, on ``g``'s device, in the dtype of ``query.adjacency_matrix``
    (float32)."""
    from . import query
    A = query.adjacency_matrix(g, weighted=True)
    d = query.degree(g, dir="out").clamp(min=1e-12)
    P = A / d[:, None]
    out = []
    M = P
    for _ in range(walk_length):
        out.append(torch.diagonal(M))
        M = M @ P
    return torch.stack(out, dim=-1)


def ppr_diffusion(g: GraphTuple, *, alpha: float = 0.85) -> GraphTuple:
    """Personalized-PageRank edge weights ``alpha * (I - (1 - alpha)
    A)^-1`` on the existing edges (transform.jl:1026-1051): the float32
    adjacency inverted densely in float64 on the host, as in the JAX
    package; the weights are float32."""
    from .query import adjacency_matrix
    h = _unpack(g)
    A = adjacency_matrix(g, weighted=True).cpu().numpy()
    ppr = alpha * np.linalg.inv(np.eye(h.nn) - (1 - alpha) * A)
    h.w = ppr[h.s, h.r].astype(np.float32)
    return _repack(h)
