"""Heterogeneous graphs: typed node sets and typed relations, at true size.

Counterpart of ``graphneuralnetworks_tpu/heterograph.py`` (reference
GNNGraphs gnnheterograph.jl:85-297, its transforms transform.jl:20-230 and
generators generate.jl:26-123). The JAX container pads each node type and
relation to its own capacity; here node arrays are ``[num_nodes[t], ...]``
and a relation's edge arrays ``[num_edges, ...]``, with no padding.

A relation ``(src_t, rel_t, dst_t)`` is a bipartite edge list: its senders
index the source type's nodes and its receivers the destination type's.
Its edges are stored receiver-sorted (stable), as in the JAX package, and
:func:`heterograph` builds its edge groupings once, on the graph's device
(:func:`~.graph.graph`, whose groupings come from :func:`~.graph.group_by`),
as a :class:`~.graph.GraphTuple` over ``max(N_src, N_dst)`` nodes: the one
node space that holds both ends. :meth:`HeteroGraphTuple.relation_graph`
returns that stored graph and does no work. The layers take it with a
bipartite ``(x_src, x_dst)`` input and cut their output to ``x_dst``'s
rows: the SpMM (K1) reads ``x_src`` of fewer rows than the graph has nodes,
and its sender-CSR backward is cut to them; rows of the receiver CSR past
``N_dst`` hold no edges.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from . import resolve_device
from .graph import GraphTuple, _tensor, graph
from .ops.segment import count_as
from .utils import _host

EType = tuple[str, str, str]

__all__ = ["Relation", "HeteroGraphTuple", "heterograph", "rand_heterograph",
           "rand_bipartite_heterograph", "add_self_loops_hetero",
           "add_edges_hetero", "batch_hetero"]


@dataclasses.dataclass(frozen=True)
class Relation:
    """One typed edge set: a bipartite COO list, receiver-sorted, and its
    groupings (``graph``, over ``max(num_src, num_dst)`` nodes)."""

    graph: GraphTuple
    num_src: int
    num_dst: int

    @property
    def senders(self) -> torch.Tensor:
        """``int64[E]`` into the source type's nodes."""
        return self.graph.senders

    @property
    def receivers(self) -> torch.Tensor:
        """``int64[E]`` into the destination type's nodes, non-decreasing."""
        return self.graph.receivers

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def data(self) -> dict:
        """Edge features, ``{name: [E, ...]}`` in the stored edge order."""
        return self.graph.edges

    @property
    def edge_weight(self) -> torch.Tensor | None:
        return self.graph.edge_weight

    @property
    def edge_mask(self) -> torch.Tensor:
        return self.graph.edge_mask

    sorted_by_receivers = True


@dataclasses.dataclass(frozen=True)
class HeteroGraphTuple:
    """Typed graph: per-type node sets and a dict of relations."""

    num_nodes: dict            # ntype -> int
    node_data: dict            # ntype -> {name: [num_nodes[t], ...]}
    relations: dict            # (srcT, relT, dstT) -> Relation
    graph_data: dict = dataclasses.field(default_factory=dict)

    # ---- queries (gnnheterograph.jl:180-297) -------------------------------
    @property
    def ntypes(self) -> list[str]:
        return list(self.num_nodes.keys())

    @property
    def etypes(self) -> list[EType]:
        return list(self.relations.keys())

    @property
    def num_node_types(self) -> int:
        return len(self.num_nodes)

    @property
    def num_edge_types(self) -> int:
        return len(self.relations)

    @property
    def device(self) -> torch.device | None:
        """The device of the relations' tensors (None without relations)."""
        for rel in self.relations.values():
            return rel.graph.device
        return None

    def __getitem__(self, key):
        """``g["ntype"]`` -> its node feature dict; ``g[(s, r, d)]`` -> the
        :class:`Relation` (gnnheterograph.jl:289-297)."""
        if isinstance(key, tuple):
            return self.relations[key]
        return self.node_data.get(key, {})

    def edge_index(self, etype: EType):
        """``(senders, receivers)`` of one relation, receiver-sorted."""
        rel = self.relations[etype]
        return rel.senders, rel.receivers

    def edge_type_subgraph(self, etypes: Sequence[EType] | EType):
        """Keep only the given relations and their endpoint types
        (gnnheterograph.jl:250-271)."""
        if isinstance(etypes, tuple) and len(etypes) == 3 and \
                all(isinstance(t, str) for t in etypes):
            etypes = [etypes]
        keep = {t for (s, _, d) in etypes for t in (s, d)}
        return HeteroGraphTuple(
            num_nodes={t: v for t, v in self.num_nodes.items() if t in keep},
            node_data={t: v for t, v in self.node_data.items() if t in keep},
            relations={et: self.relations[et] for et in etypes},
            graph_data=self.graph_data)

    def relation_graph(self, etype: EType) -> GraphTuple:
        """One relation as a :class:`~.graph.GraphTuple` for the layer zoo:
        the graph stored by :func:`heterograph`, over ``max(N_src, N_dst)``
        nodes (module docstring). Layers take ``(x_src, x_dst)`` and return
        ``x_dst``'s rows. No sort and no host work per call."""
        return self.relations[etype].graph

    def degree(self, etype: EType, *, dir: str = "in",
               dtype=torch.float32) -> torch.Tensor:
        """One relation's unweighted degree: ``dir="in"`` on the destination
        type's nodes (``[N_dst]``), ``"out"`` on the source type's
        (``[N_src]``), counted in ``dtype`` as a sum of ones in it counts
        (:func:`~.ops.segment.count_as`, as ``query.degree``)."""
        rel = self.relations[etype]
        if dir == "in":
            ip, n = rel.graph.indptr_r, rel.num_dst
        elif dir == "out":
            ip, n = rel.graph.indptr_s, rel.num_src
        else:
            raise ValueError(f"dir must be in/out, got {dir!r}")
        return count_as(torch.diff(ip[: n + 1]), dtype)

    def replace_node_data(self, ntype: str, **feats) -> "HeteroGraphTuple":
        nd = dict(self.node_data)
        nd[ntype] = {**nd.get(ntype, {}), **feats}
        return dataclasses.replace(self, node_data=nd)

    def to(self, device) -> "HeteroGraphTuple":
        """The same graph with every tensor on ``device``."""
        def mv(d):
            return {k: v.to(device) for k, v in d.items()}
        return HeteroGraphTuple(
            num_nodes=dict(self.num_nodes),
            node_data={t: mv(d) for t, d in self.node_data.items()},
            relations={et: dataclasses.replace(rel, graph=rel.graph.to(device))
                       for et, rel in self.relations.items()},
            graph_data=mv(self.graph_data))

    def __repr__(self) -> str:
        return (f"HeteroGraphTuple(num_nodes={self.num_nodes}, num_edges="
                f"{ {et: r.num_edges for et, r in self.relations.items()} }, "
                f"device={self.device})")


def heterograph(relations: Mapping[EType, tuple], *, num_nodes=None,
                node_data=None, edge_data=None, graph_data=None,
                device=None) -> HeteroGraphTuple:
    """Build a :class:`HeteroGraphTuple` on ``device`` (``None``: the CUDA
    card).

    ``relations``: ``{(srcT, relT, dstT): (senders, receivers[, weight])}``.
    ``num_nodes``: ``{ntype: n}``; a type's count grows to cover its largest
    index, as in the JAX package. ``node_data``: ``{ntype: {name:
    [n, ...]}}``, ``edge_data``: ``{etype: {name: [E, ...]}}`` in the input
    edge order. Each relation's edges are sorted by receiver (stable) and
    grouped once, on ``device`` (gnnheterograph.jl:85-160; COO only).
    """
    device = resolve_device(device)
    num_nodes = dict(num_nodes or {})
    rels_np = {}
    for et, val in relations.items():
        s = np.asarray(val[0], np.int64).reshape(-1)
        r = np.asarray(val[1], np.int64).reshape(-1)
        w = np.asarray(val[2]).reshape(-1) if len(val) > 2 else None
        src_t, _, dst_t = et
        num_nodes.setdefault(src_t, 0)
        num_nodes.setdefault(dst_t, 0)
        num_nodes[src_t] = max(num_nodes[src_t], int(s.max(initial=-1)) + 1)
        num_nodes[dst_t] = max(num_nodes[dst_t], int(r.max(initial=-1)) + 1)
        rels_np[et] = (s, r, w)
    num_nodes = {t: int(n) for t, n in num_nodes.items()}

    node_data = dict(node_data or {})
    ndata = {}
    for t, n in num_nodes.items():
        feats = {}
        for k, v in (node_data.get(t) or {}).items():
            v = _tensor(v, device)
            if v.shape[0] != n:
                raise ValueError(f"node feature {t}.{k}: leading dim "
                                 f"{v.shape[0]} != {n}")
            feats[k] = v
        ndata[t] = feats

    edge_data = dict(edge_data or {})
    rels = {}
    for et, (s, r, w) in rels_np.items():
        n_src, n_dst = num_nodes[et[0]], num_nodes[et[2]]
        g = graph(s, r, num_nodes=max(n_src, n_dst),
                  edges=edge_data.get(et) or None, edge_weight=w,
                  device=device)
        rels[et] = Relation(graph=g, num_src=n_src, num_dst=n_dst)
    gdata = {k: _tensor(v, device) for k, v in (graph_data or {}).items()}
    return HeteroGraphTuple(num_nodes=num_nodes, node_data=ndata,
                            relations=rels, graph_data=gdata)


def rand_heterograph(num_nodes: Mapping[str, int],
                     num_edges: Mapping[EType, int], *, node_data=None,
                     seed: int = 0, bidirected: bool = False,
                     device=None) -> HeteroGraphTuple:
    """Random hetero graph, uniform endpoints per relation, with the JAX
    package's numpy draws (gnnheterograph/generate.jl:26-66)."""
    rng = np.random.default_rng(seed)
    rels = {}
    for et, ne in num_edges.items():
        src_t, _, dst_t = et
        s = rng.integers(0, num_nodes[src_t], ne).astype(np.int32)
        r = rng.integers(0, num_nodes[dst_t], ne).astype(np.int32)
        rels[et] = (s, r)
        if bidirected:
            rels[(et[2], et[1] + "_rev", et[0])] = (r.copy(), s.copy())
    return heterograph(rels, num_nodes=dict(num_nodes), node_data=node_data,
                       device=device)


def rand_bipartite_heterograph(n1: int, n2: int, num_edges, *,
                               node_types=("A", "B"), rel=("to", "rev_to"),
                               bidirected: bool = True, seed: int = 0,
                               device=None) -> HeteroGraphTuple:
    """Two node types joined both ways (gnnheterograph/generate.jl:110-123):
    with ``bidirected`` the second relation reverses the first."""
    a, b = node_types
    if isinstance(num_edges, int):
        e12 = e21 = num_edges
    else:
        e12, e21 = num_edges
    rng = np.random.default_rng(seed)
    rels = {(a, rel[0], b): (rng.integers(0, n1, e12),
                             rng.integers(0, n2, e12))}
    if bidirected:
        s, r = rels[(a, rel[0], b)]
        rels[(b, rel[1], a)] = (r.copy(), s.copy())
    else:
        rels[(b, rel[1], a)] = (rng.integers(0, n2, e21),
                                rng.integers(0, n1, e21))
    return heterograph(rels, num_nodes={a: n1, b: n2}, device=device)


# ---- transforms: host-side, rebuilt by heterograph() ------------------------

def _rels_as_tuples(g: HeteroGraphTuple) -> dict:
    """Every relation as ``(s, r[, w])`` host arrays, in the stored order."""
    return {et: (_host(rel.senders), _host(rel.receivers))
            + ((_host(rel.edge_weight),) if rel.edge_weight is not None
               else ())
            for et, rel in g.relations.items()}


def _edata_dict(g: HeteroGraphTuple) -> dict:
    return {et: {k: _host(v) for k, v in rel.data.items()}
            for et, rel in g.relations.items()}


def _ndata_dict(g: HeteroGraphTuple) -> dict:
    return {t: {k: _host(v) for k, v in d.items()}
            for t, d in g.node_data.items()}


def _rebuild(g: HeteroGraphTuple, rels, edata, device) -> HeteroGraphTuple:
    return heterograph(rels, num_nodes=dict(g.num_nodes),
                       node_data=_ndata_dict(g), edge_data=edata,
                       graph_data={k: _host(v)
                                   for k, v in g.graph_data.items()},
                       device=g.device if device is None else device)


def add_self_loops_hetero(g: HeteroGraphTuple, etype: EType, *,
                          device=None) -> HeteroGraphTuple:
    """Add ``i -> i`` edges to one relation whose source and destination
    types match (gnnheterograph/transform.jl:20-76); a weighted relation
    gives them weight 1 and its edge features zeros (the JAX package's
    zero-fill). ``device=None`` keeps ``g``'s device."""
    src_t, _, dst_t = etype
    if src_t != dst_t:
        raise ValueError("self loops need src type == dst type "
                         "(transform.jl:20-41)")
    n = g.num_nodes[src_t]
    rels = _rels_as_tuples(g)
    old = rels[etype]
    loops = np.arange(n)
    tup = (np.concatenate([old[0], loops]), np.concatenate([old[1], loops]))
    if len(old) > 2:
        tup = tup + (np.concatenate([old[2], np.ones(n, old[2].dtype)]),)
    rels[etype] = tup
    edata = _edata_dict(g)
    if edata.get(etype):
        edata[etype] = {
            k: np.concatenate([v, np.zeros((n,) + v.shape[1:], v.dtype)])
            for k, v in edata[etype].items()}
    return _rebuild(g, rels, edata, device)


def add_edges_hetero(g: HeteroGraphTuple, etype: EType, senders, receivers,
                     *, edge_weight=None, edata=None,
                     device=None) -> HeteroGraphTuple:
    """Append edges to one relation, creating it if absent
    (gnnheterograph/transform.jl:92-163). ``edata`` (a feature dict, or one
    array for ``"e"``) holds the new edges' features; a key on one side
    only is zero-filled on the other (transform.jl:130-136). A weight on
    either side gives the other side weight 1. ``device=None`` keeps
    ``g``'s device."""
    rels = _rels_as_tuples(g)
    all_edata = _edata_dict(g)
    s2 = np.asarray(senders, np.int64).reshape(-1)
    r2 = np.asarray(receivers, np.int64).reshape(-1)
    if edata is not None and not isinstance(edata, Mapping):
        edata = {"e": edata}
    new_edata = {k: _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                 for k, v in (edata or {}).items()}
    for k, v in new_edata.items():
        if v.shape[0] != len(s2):
            raise ValueError(f"edata {k!r} leading dim {v.shape[0]} != "
                             f"{len(s2)} new edges")
    if etype in rels:
        old = rels[etype]
        ne_old = len(old[0])
        s = np.concatenate([old[0], s2])
        r = np.concatenate([old[1], r2])
        if len(old) > 2 or edge_weight is not None:
            ow = old[2] if len(old) > 2 else np.ones(ne_old)
            nw = (np.asarray(edge_weight) if edge_weight is not None
                  else np.ones(len(s2)))
            rels[etype] = (s, r, np.concatenate([ow, nw]))
        else:
            rels[etype] = (s, r)
        old_edata = all_edata.get(etype, {})
        merged = {}
        for k in {*old_edata, *new_edata}:
            ov, nv = old_edata.get(k), new_edata.get(k)
            if ov is None:
                ov = np.zeros((ne_old,) + nv.shape[1:], nv.dtype)
            if nv is None:
                nv = np.zeros((len(s2),) + ov.shape[1:], ov.dtype)
            merged[k] = np.concatenate([ov, nv])
        all_edata[etype] = merged
    else:
        rels[etype] = ((s2, r2) if edge_weight is None
                       else (s2, r2, np.asarray(edge_weight)))
        all_edata[etype] = new_edata
    return _rebuild(g, rels, all_edata, device)


def batch_hetero(graphs: Sequence[HeteroGraphTuple], *,
                 device=None) -> HeteroGraphTuple:
    """Disjoint union of hetero graphs (gnnheterograph/transform.jl:
    165-230): node ids offset per type, each relation's edges
    concatenated, features and ``graph_data`` concatenated on their leading
    axis. Built on the host; ``device=None`` places it on the CUDA card."""
    if not graphs:
        raise ValueError("empty batch")
    ntypes, etypes = graphs[0].ntypes, graphs[0].etypes
    nnodes, ndata = {}, {}
    for t in ntypes:
        nnodes[t] = sum(g.num_nodes[t] for g in graphs)
        ndata[t] = {k: np.concatenate([_host(g.node_data[t][k])
                                       for g in graphs])
                    for k in graphs[0].node_data.get(t, {})}
    rels, edata = {}, {}
    for et in etypes:
        src_t, _, dst_t = et
        ss, rs, ws = [], [], []
        s_off = d_off = 0
        any_w = any(g.relations[et].edge_weight is not None for g in graphs)
        efeats = {k: [] for k in graphs[0].relations[et].data}
        for g in graphs:
            rel = g.relations[et]
            ss.append(_host(rel.senders) + s_off)
            rs.append(_host(rel.receivers) + d_off)
            if any_w:
                ws.append(_host(rel.edge_weight) if rel.edge_weight
                          is not None else np.ones(rel.num_edges))
            for k, acc in efeats.items():
                acc.append(_host(rel.data[k]))
            s_off += g.num_nodes[src_t]
            d_off += g.num_nodes[dst_t]
        rels[et] = (np.concatenate(ss), np.concatenate(rs)) + (
            (np.concatenate(ws),) if any_w else ())
        if efeats:
            edata[et] = {k: np.concatenate(v) for k, v in efeats.items()}
    gdata = {k: np.concatenate([np.atleast_1d(_host(g.graph_data[k]))
                                for g in graphs])
             for k in graphs[0].graph_data}
    return heterograph(rels, num_nodes=nnodes, node_data=ndata,
                       edge_data=edata or None, graph_data=gdata or None,
                       device=device)
