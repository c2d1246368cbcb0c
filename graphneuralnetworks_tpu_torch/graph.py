"""GraphTuple: the port's graph container, at true size.

Counterpart of ``graphneuralnetworks_tpu/graph.py``. The JAX container pads
every array to a static capacity because XLA compiles for fixed shapes;
PyTorch runs eagerly, so here node arrays are ``[num_nodes, ...]`` and edge
arrays ``[num_edges, ...]``, with no padding: ``node_mask`` is all True, and
so is ``edge_mask`` unless the graph carries ``edge_valid``.

``edge_valid`` (``bool[E]``, in edge order, as JAX's field) marks the edges
that count. ``DeviceSampler`` sets it: its slot graph keeps one structure
for every batch, and the draws below a node with no in-edges (or past a
node's degree, without replacement) are invalid slots; so does
``TemporalGraph.from_snapshots(uniform=True)`` on its pad edges.
``edge_mask`` returns it. Every route honours it as JAX's do through
``edge_mask``: the segment ops take it as their mask, the SpMM weighs an
invalid edge 0, and the receiver-order kernels walk the CSRs compacted to
the valid edges (:func:`csr_view`). ``apply_edges`` computes every edge,
as JAX's reads no mask; ``batch`` and the host transforms raise on such a
graph, as JAX's do (:func:`no_edge_valid`).

Edges are stored sorted by receiver (stable). ``graph()`` builds both edge
groupings on the host once and moves them to the device; ``device_graph()``
builds the same arrays on the device of its COO tensors (a loader's batch),
with no copy back to the host:

- by receiver: ``indptr_r`` (``int32[N + 1]``) and ``col_r`` (the senders,
  ``int32[E]``). Because edges are receiver-sorted, a CSR position is the
  edge id.
- by sender: ``indptr_s``, ``col_s`` (the receivers in sender order) and
  ``eid_s`` (the edge id of each position), from a stable argsort; None
  where the positions are the edge ids (a reversed graph's, the device
  sampler's slot graphs, whose senders ascend).
- by graph, when ``node_graph_id`` is non-decreasing (what ``batch``
  produces, and what the JAX package's ``reduce_nodes`` assumes): the
  nodes of graph ``b`` are ``indptr_g[b]:indptr_g[b+1]`` (``int32[G + 1]``)
  and, because an edge belongs to its receiver's graph and edges are
  receiver-sorted, its edges ``indptr_ge[b]:indptr_ge[b+1]``. Both are None
  for unsorted ids.

The kernels (``ops/cuda``) run over these; they take the place of the JAX
package's ``SpmmAux`` block groupings.

``reverse()`` swaps senders and receivers and keeps the edge order, as the
JAX package's does, so an edge array of ``g`` is still one of
``g.reverse()``. Its receiver grouping is ``g``'s sender grouping, whose
positions are not edge ids: ``eid_r`` maps them (``g``'s ``eid_s``), and
its sender grouping is ``g``'s receiver grouping, whose positions are
(``eid_s`` None). A graph from ``graph()`` has ``eid_r`` None: its edges
are receiver-sorted (``sorted_by_receivers``). A route that reads an edge
array by CSR position reads it through the position's edge id
(:func:`csr_view`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import resolve_device

__all__ = ["GraphTuple", "graph", "device_graph", "from_dense_adjacency"]

FeatureDict = dict[str, torch.Tensor]

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class GraphTuple:
    """A graph (possibly a batch of graphs) with its two edge groupings."""

    senders: torch.Tensor                  # int64[E], receiver-sorted order
    receivers: torch.Tensor                # int64[E], non-decreasing
    num_nodes: int
    num_edges: int
    num_graphs: int
    node_graph_id: torch.Tensor            # int64[N]
    indptr_r: torch.Tensor                 # int32[N + 1]
    col_r: torch.Tensor                    # int32[E] senders
    indptr_s: torch.Tensor                 # int32[N + 1]
    col_s: torch.Tensor                    # int32[E] receivers, sender order
    eid_s: torch.Tensor | None             # int32[E] edge id, sender order
    nodes: FeatureDict = dataclasses.field(default_factory=dict)
    edges: FeatureDict = dataclasses.field(default_factory=dict)
    globals_: FeatureDict = dataclasses.field(default_factory=dict)
    edge_weight: torch.Tensor | None = None
    indptr_g: torch.Tensor | None = None   # int32[G + 1] nodes by graph
    indptr_ge: torch.Tensor | None = None  # int32[G + 1] edges by graph
    eid_r: torch.Tensor | None = None      # int32[E] edge id, receiver order
    edge_valid: torch.Tensor | None = None  # bool[E] edges that count

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def sorted_by_receivers(self) -> bool:
        """Whether the edges are in receiver order: True for a graph from
        ``graph()``, False after :meth:`reverse` (as JAX sets it). JAX's
        ``GraphTuple`` carries it as a field, and code ported from there
        passes it to the segment ops as ``sorted=``."""
        return self.eid_r is None

    # ---- masks (no padding: all True but for edge_valid) -------------------
    @property
    def node_mask(self) -> torch.Tensor:
        return torch.ones(self.num_nodes, dtype=torch.bool, device=self.device)

    @property
    def edge_mask(self) -> torch.Tensor:
        """``bool[E]``: ``edge_valid`` where the graph has it, else all
        True (JAX's mask of the real edges ANDed with ``edge_valid``)."""
        if self.edge_valid is not None:
            return self.edge_valid
        return torch.ones(self.num_edges, dtype=torch.bool, device=self.device)

    @property
    def graph_mask(self) -> torch.Tensor:
        return torch.ones(self.num_graphs, dtype=torch.bool,
                          device=self.device)

    # ---- feature access ----------------------------------------------------
    @property
    def x(self) -> torch.Tensor | None:
        return self.nodes.get("x")

    @property
    def e(self) -> torch.Tensor | None:
        return self.edges.get("e")

    def edge_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.senders, self.receivers

    def get_edge_weight(self) -> torch.Tensor | None:
        return self.edge_weight

    # ---- functional updates ------------------------------------------------
    def replace(self, **kw) -> "GraphTuple":
        return dataclasses.replace(self, **kw)

    def with_nodes(self, **feats) -> "GraphTuple":
        return self.replace(nodes={**self.nodes, **feats})

    def with_edges(self, **feats) -> "GraphTuple":
        return self.replace(edges={**self.edges, **feats})

    def with_globals(self, **feats) -> "GraphTuple":
        return self.replace(globals_={**self.globals_, **feats})

    def reverse(self) -> "GraphTuple":
        """Every edge turned round (senders and receivers swapped), in the
        same edge order: the two groupings swap, with no copy and no sort
        (module docstring). ``reverse().reverse()`` is ``self``'s
        groupings again."""
        return self.replace(
            senders=self.receivers, receivers=self.senders,
            indptr_r=self.indptr_s, col_r=self.col_s, eid_r=self.eid_s,
            indptr_s=self.indptr_r, col_s=self.col_r, eid_s=self.eid_r)

    def to(self, device) -> "GraphTuple":
        """The same graph with every tensor on ``device``."""
        def mv(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, dict):
                return {k: t.to(device) for k, t in v.items()}
            return v
        return self.replace(**{f.name: mv(getattr(self, f.name))
                               for f in dataclasses.fields(self)})

    def __repr__(self) -> str:
        return (f"GraphTuple(num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges}, num_graphs={self.num_graphs}, "
                f"device={self.device}, nodes={list(self.nodes)}, "
                f"edges={list(self.edges)}, globals={list(self.globals_)})")


class CsrView(NamedTuple):
    """The two CSRs that the receiver-order kernels walk (:func:`csr_view`).

    ``eid_r`` / ``eid_s`` map each position of the receiver / sender CSR to
    its edge id (None: the positions are the edge ids). A compacted view
    keeps its arrays at the graph's ``E`` entries and fills the first
    ``indptr[-1]`` of them; the kernels read no further."""

    indptr_r: torch.Tensor
    col_r: torch.Tensor
    eid_r: torch.Tensor | None
    indptr_s: torch.Tensor
    col_s: torch.Tensor
    eid_s: torch.Tensor | None


def _compact(indptr, col, eid, valid):
    """One CSR cut to its valid entries, on its device with no read back to
    the host: a stable partition of the positions (valid ones first, in
    order) from a running count of the validity in CSR order, the offsets
    moved down by the invalid entries before them, and the map to edge ids
    composed with ``eid``."""
    v = valid if eid is None else valid.index_select(0, eid.long())
    c = torch.cumsum(v, 0, dtype=torch.int32)
    pos = torch.arange(v.numel(), device=v.device, dtype=torch.int32)
    total = c[-1:] if v.numel() else c.new_zeros(1)
    dest = torch.where(v, c - 1, total + pos - c)
    perm = torch.empty_like(pos).index_put_((dest.long(),), pos)
    kept = torch.cat([c.new_zeros(1), c])[indptr.long()]
    new_eid = perm if eid is None else eid.index_select(0, perm.long())
    return kept, col.index_select(0, perm.long()), new_eid


def csr_view(g: GraphTuple) -> CsrView:
    """The receiver and sender CSRs of ``g`` that a receiver-order kernel
    walks, with the map from each position to its edge id, so that edge
    arrays (in edge order) are read and written through it:

    - a graph from ``graph()``: its groupings (receiver positions are edge
      ids, ``eid_r`` None);
    - a reversed graph: its groupings too, ``eid_r`` mapping the receiver
      CSR (``g``'s sender CSR before ``reverse``);
    - a graph with ``edge_valid``: both CSRs compacted to the valid edges
      (:func:`_compact`), so an invalid edge is in no row and a receiver
      whose edges are all invalid has an empty one; on a reversed graph
      the maps compose.

    Built once per graph and kept on it, like its groupings (``replace``
    makes a new graph, without it)."""
    view = g.__dict__.get("_csr_view")
    if view is None:
        view = CsrView(g.indptr_r, g.col_r, g.eid_r, g.indptr_s, g.col_s,
                       g.eid_s)
        if g.edge_valid is not None:
            view = CsrView(
                *_compact(g.indptr_r, g.col_r, g.eid_r, g.edge_valid),
                *_compact(g.indptr_s, g.col_s, g.eid_s, g.edge_valid))
        g.__dict__["_csr_view"] = view
    return view


def no_edge_valid(g: GraphTuple, route: str) -> None:
    """Raise ``ValueError`` if ``route`` is given a graph with
    ``edge_valid``: ``batch``, which JAX's refuses too (its host
    surgery would count the invalid edges as real)."""
    if g.edge_valid is not None:
        raise ValueError(f"{route} does not take a graph with edge_valid "
                         "(a sampled slot graph or padded snapshot): its "
                         "invalid edges would count as real")


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def _feats(feats, n: int, what: str, device, order=None) -> FeatureDict:
    """Dict of ``[n, ...]`` tensors on ``device``, rows permuted by ``order``."""
    if feats is None:
        return {}
    if not isinstance(feats, Mapping):
        feats = {{"node": "x", "edge": "e"}.get(what, "u"): feats}
    out = {}
    for k, v in feats.items():
        t = _tensor(v, device)
        if what == "global" and t.dim() == 0:
            t = t[None]
        if t.shape[0] != n:
            raise ValueError(f"{what} feature {k!r}: leading dim "
                             f"{t.shape[0]} != {n}")
        out[k] = t if order is None else t[order.to(t.device)]
    return out


def group_by(keys: torch.Tensor, n: int):
    """Group the positions of ``keys`` (ids in ``[0, n)``) by id, on the
    keys' device: ``(sorted keys, order, indptr)``, int32 but ``order``
    (int64), from a stable ``torch.sort`` (ties keep their position order)
    and ``torch.searchsorted`` over the sorted keys. Nothing is read back
    to the host (no ``bincount`` or ``nonzero``). Every edge grouping of the
    package is built here."""
    # int32 keys: half the radix passes of int64 ones on the card
    k_sorted, order = torch.sort(keys.int(), stable=True)
    ids = torch.arange(int(n) + 1, device=keys.device, dtype=torch.int32)
    return k_sorted, order, torch.searchsorted(k_sorted, ids, out_int32=True)


def _groupings(s: torch.Tensor, r: torch.Tensor, nn: int):
    """Both edge groupings of COO ``s -> r``: ``order`` (receiver order of
    the input edges) and the senders, receivers, ``indptr_r``, ``col_r``,
    ``indptr_s``, ``col_s`` and ``eid_s`` fields of a GraphTuple."""
    r_sorted, order, indptr_r = group_by(r, nn)
    s_sorted = s.int()[order]
    _, by_s, indptr_s = group_by(s_sorted, nn)
    return order, dict(senders=s_sorted.long(), receivers=r_sorted.long(),
                       indptr_r=indptr_r, col_r=s_sorted, indptr_s=indptr_s,
                       col_s=r_sorted[by_s], eid_s=by_s.int())


def graph(senders, receivers, *, num_nodes=None, nodes=None, edges=None,
          globals_=None, edge_weight=None, node_graph_id=None,
          num_graphs: int = 1, device=None) -> GraphTuple:
    """Build a :class:`GraphTuple` from COO edges ``senders[k] -> receivers[k]``.

    Edges are directed; features are numpy arrays or tensors with one row
    per node/edge/graph. ``device=None`` places the graph on the CUDA card.
    """
    device = resolve_device(device)
    s = np.ascontiguousarray(senders, dtype=np.int64).reshape(-1)
    r = np.ascontiguousarray(receivers, dtype=np.int64).reshape(-1)
    if s.shape != r.shape:
        raise ValueError("senders/receivers length mismatch")
    ne = int(s.shape[0])
    if num_nodes is None:
        num_nodes = int(max(s.max(initial=-1), r.max(initial=-1)) + 1)
    nn = int(num_nodes)
    if ne and (s.max() >= nn or r.max() >= nn or s.min() < 0 or r.min() < 0):
        raise ValueError("edge index out of range")
    if ne > _INT32_MAX or nn > _INT32_MAX:
        raise ValueError(f"at most {_INT32_MAX} nodes and edges (the edge "
                         "groupings are int32)")

    order, groups = _groupings(torch.from_numpy(s).to(device),
                               torch.from_numpy(r).to(device), nn)
    if edge_weight is not None:
        edge_weight = _tensor(edge_weight, device).reshape(-1)
        if edge_weight.shape[0] != ne:
            raise ValueError("edge_weight length mismatch")
        edge_weight = edge_weight[order]

    ng = int(num_graphs)
    if node_graph_id is None:
        gid_np = np.zeros(nn, np.int64)
    else:
        gid_np = np.asarray(node_graph_id.cpu() if isinstance(
            node_graph_id, torch.Tensor) else node_graph_id).astype(np.int64)
        if gid_np.shape != (nn,):
            raise ValueError("node_graph_id length mismatch")
    gid = torch.from_numpy(gid_np).to(device)
    indptr_g = indptr_ge = None
    if (np.all(gid_np[1:] >= gid_np[:-1])
            and (nn == 0 or (gid_np[0] >= 0 and gid_np[-1] < ng))):
        indptr_g = group_by(gid, ng)[2]
        indptr_ge = groups["indptr_r"][indptr_g]

    return GraphTuple(
        num_nodes=nn,
        num_edges=ne,
        num_graphs=ng,
        node_graph_id=gid,
        **groups,
        nodes=_feats(nodes, nn, "node", device),
        edges=_feats(edges, ne, "edge", device, order),
        globals_=_feats(globals_, ng, "global", device),
        edge_weight=edge_weight,
        indptr_g=indptr_g,
        indptr_ge=indptr_ge,
    )


def device_graph(senders: torch.Tensor, receivers: torch.Tensor, *,
                 num_nodes: int, nodes=None, edges=None,
                 edge_weight=None) -> GraphTuple:
    """:func:`graph` of one graph whose COO ``senders[k] -> receivers[k]``
    are tensors already on their device: the groupings are built there.

    The groupings are :func:`graph`'s (:func:`group_by` by receiver, then
    by sender). Nothing is read back to the host (no ``.item()`` or range
    check), so a loader's batch is queued on the card behind the step
    before it. The caller vouches that every id lies in ``[0, num_nodes)``:
    a sampler's local ids do. ``nodes``, ``edges`` and ``edge_weight`` are
    tensors, the edge ones in the input edge order.
    """
    s = senders.reshape(-1)
    r = receivers.reshape(-1)
    if s.shape != r.shape:
        raise ValueError("senders/receivers length mismatch")
    nn, ne = int(num_nodes), int(s.numel())
    if ne > _INT32_MAX or nn > _INT32_MAX:
        raise ValueError(f"at most {_INT32_MAX} nodes and edges (the edge "
                         "groupings are int32)")
    dev = s.device
    order, groups = _groupings(s, r, nn)

    def in_order(v, what):
        if v is None:
            return None
        if v.shape[0] != ne:
            raise ValueError(f"{what}: leading dim {v.shape[0]} != {ne}")
        return v[order]

    def node_feats(feats):
        for k, v in (feats or {}).items():
            if v.shape[0] != nn:
                raise ValueError(f"node feature {k!r}: leading dim "
                                 f"{v.shape[0]} != {nn}")
        return dict(feats or {})

    return GraphTuple(
        num_nodes=nn,
        num_edges=ne,
        num_graphs=1,
        node_graph_id=torch.zeros(nn, dtype=torch.int64, device=dev),
        **groups,
        nodes=node_feats(nodes),
        edges={k: in_order(v, f"edge feature {k!r}")
               for k, v in (edges or {}).items()},
        edge_weight=in_order(edge_weight, "edge_weight"),
        # one graph: [0, N] and [0, E], made on the device (a host tensor
        # would be a copy)
        indptr_g=torch.arange(2, device=dev, dtype=torch.int32) * nn,
        indptr_ge=torch.arange(2, device=dev, dtype=torch.int32) * ne,
    )


def from_dense_adjacency(adj, **kw) -> GraphTuple:
    """Build from a dense adjacency: nonzero ``A[i, j]`` is an edge ``i -> j``
    with weight ``A[i, j]`` (weights are kept unless all are 1)."""
    A = np.asarray(adj)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("adjacency must be square")
    s, r = np.nonzero(A)
    w = A[s, r]
    if not np.all(w == 1):
        kw.setdefault("edge_weight", w.astype(np.float32))
    return graph(s, r, num_nodes=A.shape[0], **kw)

