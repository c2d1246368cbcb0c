"""GraphTuple: the port's graph container, at true size.

Counterpart of ``graphneuralnetworks_tpu/graph.py``. The JAX container pads
every array to a static capacity because XLA compiles for fixed shapes;
PyTorch runs eagerly, so here node arrays are ``[num_nodes, ...]`` and edge
arrays ``[num_edges, ...]``, and ``node_mask``/``edge_mask`` are all True.

Edges are stored sorted by receiver (stable), and ``graph()`` builds both
edge groupings on the host once and moves them to the device:

- by receiver: ``indptr_r`` (``int32[N + 1]``) and ``col_r`` (the senders,
  ``int32[E]``). Because edges are receiver-sorted, a CSR position is the
  edge id.
- by sender: ``indptr_s``, ``col_s`` (the receivers in sender order) and
  ``eid_s`` (the edge id of each position), from a stable argsort.

The SpMM kernels (``ops/cuda``) run over these; they take the place of the
JAX package's ``SpmmAux`` block groupings.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import resolve_device

__all__ = ["GraphTuple", "graph", "from_dense_adjacency"]

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
    eid_s: torch.Tensor                    # int32[E] edge id, sender order
    nodes: FeatureDict = dataclasses.field(default_factory=dict)
    edges: FeatureDict = dataclasses.field(default_factory=dict)
    globals_: FeatureDict = dataclasses.field(default_factory=dict)
    edge_weight: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.senders.device

    # ---- masks (all True: no padding; kept for API parity) -----------------
    @property
    def node_mask(self) -> torch.Tensor:
        return torch.ones(self.num_nodes, dtype=torch.bool, device=self.device)

    @property
    def edge_mask(self) -> torch.Tensor:
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


def _indptr(keys: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(keys, minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def graph(senders, receivers, *, num_nodes=None, nodes=None, edges=None,
          globals_=None, edge_weight=None, node_graph_id=None,
          num_graphs: int = 1, device=None) -> GraphTuple:
    """Build a :class:`GraphTuple` from COO edges ``senders[k] -> receivers[k]``.

    Edges are directed; features are numpy arrays or tensors with one row
    per node/edge/graph. ``device=None`` places the graph on the CUDA card.
    """
    device = resolve_device(device)
    s = np.asarray(senders, dtype=np.int64).reshape(-1)
    r = np.asarray(receivers, dtype=np.int64).reshape(-1)
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

    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    order_t = torch.from_numpy(order)
    if edge_weight is not None:
        edge_weight = _tensor(edge_weight, device).reshape(-1)
        if edge_weight.shape[0] != ne:
            raise ValueError("edge_weight length mismatch")
        edge_weight = edge_weight[order_t.to(device)]

    by_s = np.argsort(s, kind="stable")
    if node_graph_id is None:
        gid = torch.zeros(nn, dtype=torch.int64, device=device)
    else:
        gid = _tensor(node_graph_id, device).long()
        if gid.shape[0] != nn:
            raise ValueError("node_graph_id length mismatch")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GraphTuple(
        senders=dev(s),
        receivers=dev(r),
        num_nodes=nn,
        num_edges=ne,
        num_graphs=int(num_graphs),
        node_graph_id=gid,
        indptr_r=dev(_indptr(r, nn)),
        col_r=dev(s.astype(np.int32)),
        indptr_s=dev(_indptr(s, nn)),
        col_s=dev(r[by_s].astype(np.int32)),
        eid_s=dev(by_s.astype(np.int32)),
        nodes=_feats(nodes, nn, "node", device),
        edges=_feats(edges, ne, "edge", device, order_t),
        globals_=_feats(globals_, int(num_graphs), "global", device),
        edge_weight=edge_weight,
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

