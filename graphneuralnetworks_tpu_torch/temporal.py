"""Temporal graphs: a sequence of graph snapshots.

Counterpart of ``graphneuralnetworks_tpu/temporal.py`` (reference GNNGraphs
temporalsnapshotsgnngraph.jl:56-244). A static graph with time-varying
features needs no container: the recurrent layers take one
:class:`~.graph.GraphTuple` and features ``[T, N, D]``. Graphs that vary
over time are a :class:`TemporalGraph` of snapshots.

The JAX package's ``from_snapshots(uniform=True)`` re-pads every snapshot
to one ``(n_pad, e_pad)`` so that ``stacked()`` can stack them. The port's
pads every snapshot to the largest node and edge count among them
(:func:`_pad_snapshot`): isolated nodes with zero features after the real
ones, and pad edges after the real ones, marked invalid by ``edge_valid``
(which every route honours), so the real rows and edges stay where JAX
has them. :meth:`stacked` stacks snapshots of one node and one edge count
(a uniform set) and raises ``ValueError`` otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .graph import GraphTuple

__all__ = ["TemporalGraph"]


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """A sequence of graph snapshots and temporal-global features
    ``tgdata``."""

    snapshots: list            # list[GraphTuple]
    tgdata: dict = dataclasses.field(default_factory=dict)

    # ---- queries (temporalsnapshotsgnngraph.jl:100-244) --------------------
    @property
    def num_snapshots(self) -> int:
        return len(self.snapshots)

    @property
    def num_nodes(self) -> list:
        return [g.num_nodes for g in self.snapshots]

    @property
    def num_edges(self) -> list:
        return [g.num_edges for g in self.snapshots]

    def __len__(self) -> int:
        return len(self.snapshots)

    def __getitem__(self, t):
        """Time indexing: an int gives a snapshot, a slice or a list a
        :class:`TemporalGraph` (temporalsnapshotsgnngraph.jl:106-130)."""
        if isinstance(t, int):
            return self.snapshots[t]
        if isinstance(t, slice):
            return dataclasses.replace(self, snapshots=self.snapshots[t])
        return dataclasses.replace(
            self, snapshots=[self.snapshots[i] for i in t])

    def add_snapshot(self, t: int, g: GraphTuple) -> "TemporalGraph":
        """Insert a snapshot at time ``t`` (temporalsnapshotsgnngraph.jl:
        132-166)."""
        snaps = list(self.snapshots)
        snaps.insert(t, g)
        return dataclasses.replace(self, snapshots=snaps)

    def remove_snapshot(self, t: int) -> "TemporalGraph":
        """temporalsnapshotsgnngraph.jl:168-201."""
        snaps = list(self.snapshots)
        snaps.pop(t)
        return dataclasses.replace(self, snapshots=snaps)

    def node_features(self, key: str = "x") -> list:
        """A node feature of every snapshot (None where one lacks it;
        temporalsnapshotsgnngraph.jl:219-225)."""
        return [g.nodes.get(key) for g in self.snapshots]

    def with_tgdata(self, **feats) -> "TemporalGraph":
        return dataclasses.replace(self, tgdata={**self.tgdata, **feats})

    # ---- constructors ------------------------------------------------------
    @staticmethod
    def from_snapshots(snapshots: Sequence[GraphTuple], *, tgdata=None,
                       uniform: bool = False) -> "TemporalGraph":
        """Wrap snapshots; ``uniform=True`` pads them to the largest node
        and edge count among them (module docstring), so that they share
        one shape: A3TGCN's softmax over time and :meth:`stacked` take
        them. Snapshots of one size are kept as they are, but for an
        all-True ``edge_valid`` where others need pad edges."""
        snaps = list(snapshots)
        if uniform and snaps:
            n = max(g.num_nodes for g in snaps)
            e = max(g.num_edges for g in snaps)
            valid = any(g.num_edges < e or g.edge_valid is not None
                        for g in snaps)
            snaps = [_pad_snapshot(g, n, e, valid) for g in snaps]
        return TemporalGraph(snapshots=snaps, tgdata=dict(tgdata or {}))

    def stacked(self) -> GraphTuple:
        """One :class:`~.graph.GraphTuple` whose every tensor has a leading
        time axis. The snapshots must have one node count and one edge
        count (``from_snapshots(uniform=True)`` pads them to one); else
        ``ValueError``."""
        shapes = {(g.num_nodes, g.num_edges) for g in self.snapshots}
        if len(shapes) != 1:
            raise ValueError(
                "stacked() needs snapshots of one node and one edge count, "
                f"got (nodes, edges) {sorted(shapes)}; build the graph with "
                "from_snapshots(..., uniform=True)")

        def stack(vals, name):
            if all(v is None for v in vals):
                return None
            if any(v is None for v in vals):
                raise ValueError(f"stacked(): {name} is set on some "
                                 "snapshots only")
            if isinstance(vals[0], dict):
                if len({tuple(sorted(v)) for v in vals}) != 1:
                    raise ValueError(f"stacked(): {name} keys differ")
                return {k: torch.stack([v[k] for v in vals])
                        for k in vals[0]}
            if isinstance(vals[0], torch.Tensor):
                return torch.stack(vals)
            if len(set(vals)) != 1:
                raise ValueError(f"stacked(): {name} differs")
            return vals[0]

        return dataclasses.replace(self.snapshots[0], **{
            f.name: stack([getattr(g, f.name) for g in self.snapshots],
                          f.name)
            for f in dataclasses.fields(GraphTuple)})


def _pad_snapshot(g: GraphTuple, n: int, e: int, valid: bool) -> GraphTuple:
    """``g`` with ``n`` nodes and ``e`` edges: isolated nodes of zero
    features (graph id the last graph's) after its own, and pad edges
    ``n - 1 -> n - 1`` of zero features and weight after its own, rebuilt
    by the host surgery of ``transform`` (which, like JAX's, refuses a
    graph that already has ``edge_valid`` and orders edges by receiver: the
    pad edges stay last). With ``valid``, ``edge_valid`` marks the pad
    edges invalid (all True where there are none)."""
    from .transform import _repack, _unpack

    if (g.num_nodes, g.num_edges) == (n, e):
        if valid and g.edge_valid is None:
            g = g.replace(edge_valid=torch.ones(e, dtype=torch.bool,
                                                device=g.device))
        return g
    h = _unpack(g)
    pn, pe = n - h.nn, e - h.ne

    def more(v, k):
        return np.concatenate([v, np.zeros((k,) + v.shape[1:], v.dtype)])

    h.s = np.concatenate([h.s, np.full(pe, n - 1, h.s.dtype)])
    h.r = np.concatenate([h.r, np.full(pe, n - 1, h.r.dtype)])
    h.w = None if h.w is None else more(h.w, pe)
    h.nodes = {k: more(v, pn) for k, v in h.nodes.items()}
    h.edges = {k: more(v, pe) for k, v in h.edges.items()}
    h.gid = np.concatenate([h.gid, np.full(pn, max(h.ng - 1, 0),
                                           h.gid.dtype)])
    h.nn, h.ne = n, e
    out = _repack(h)
    if valid:
        out = out.replace(edge_valid=torch.arange(e, device=out.device)
                          < e - pe)
    return out
