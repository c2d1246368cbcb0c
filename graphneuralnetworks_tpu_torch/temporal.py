"""Temporal graphs: a sequence of graph snapshots.

Counterpart of ``graphneuralnetworks_tpu/temporal.py`` (reference GNNGraphs
temporalsnapshotsgnngraph.jl:56-244). A static graph with time-varying
features needs no container: the recurrent layers take one
:class:`~.graph.GraphTuple` and features ``[T, N, D]``. Graphs that vary
over time are a :class:`TemporalGraph` of snapshots.

The JAX package's ``from_snapshots(uniform=True)`` re-pads every snapshot
to one ``(n_pad, e_pad)`` so that ``stacked()`` can stack them. The port
keeps every snapshot at its true size and pads nothing, so both take only
snapshots that already agree: ``uniform=True`` checks for one node count
(all that A3TGCN's softmax over time needs) and :meth:`stacked` for one
node and one edge count; each raises ``ValueError`` otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
        """Wrap snapshots. ``uniform=True`` asks for snapshots of one node
        count: the JAX package pads them to one, and the port, which pads
        nothing, raises ``ValueError`` when they differ."""
        snaps = list(snapshots)
        if uniform and len({g.num_nodes for g in snaps}) > 1:
            raise ValueError(
                "from_snapshots(uniform=True): the snapshots have node "
                f"counts {sorted({g.num_nodes for g in snaps})}; the port "
                "keeps true sizes and does not pad them to one")
        return TemporalGraph(snapshots=snaps, tgdata=dict(tgdata or {}))

    def stacked(self) -> GraphTuple:
        """One :class:`~.graph.GraphTuple` whose every tensor has a leading
        time axis. The snapshots must have one node count and one edge
        count (the port pads none to a common size); else ``ValueError``."""
        shapes = {(g.num_nodes, g.num_edges) for g in self.snapshots}
        if len(shapes) != 1:
            raise ValueError(
                "stacked() needs snapshots of one node and one edge count, "
                f"got (nodes, edges) {sorted(shapes)}; the port keeps true "
                "sizes and does not pad them to one")

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
