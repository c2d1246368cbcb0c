"""Host-side graph partitioning for multi-device full-graph training.

Counterpart of ``graphneuralnetworks_tpu/parallel/partition.py``. Nodes are
assigned to parts; each edge lives on its receiver's part, so a part owns
every in-edge of its nodes; the senders that other parts own reach it
through one ``all_to_all`` of the halo rows (``shardgraph.py``).

The JAX package pads every part to one static shape (``n_local``,
``e_local``, ``h_max``) and stacks the parts on a leading axis, because one
``shard_map`` program serves them all. Here each part runs in its own
process (``shard.py``) and keeps its true size: part ``p`` holds
``len(owned[p])`` nodes and its own edges, and the halo exchange moves
uneven blocks. A :class:`PartitionedGraph` is the whole partition on the
host, in numpy; :func:`~.shardgraph.shard_graph_local` builds one part's
view on its device.

Per part ``p``, in the edges' stored order (the graph's receiver order, so
the local receivers ascend):

- ``owned[p]``: the global ids of the nodes it owns, ascending (a node's
  local id is its position here);
- ``recv_local[p]``: each edge's receiver, local;
- ``send_buf[p]``: each edge's sender in the halo buffer, the blocks
  received from parts ``0 .. P-1`` one after the other, block ``q``
  holding ``halo[q][p]``;
- ``halo[q][p]``: the local ids (in ``q``'s numbering) of the rows part
  ``q`` ships to part ``p``, ascending; ``halo[p][p]`` is the part's own
  rows that its edges read, which the exchange copies in place.

With ``split_local`` (the default) each part's edges also split into the
owned ones, whose sender it owns (``own_recv``, ``own_send`` local ids),
and the remote ones (``rem_recv``, ``rem_send`` into a buffer of the
off-diagonal blocks alone), so that the owned half needs no exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PartitionedGraph", "partition_graph", "partition_nodes"]


def partition_nodes(senders, receivers, num_nodes: int, num_parts: int, *,
                    balance: float = 1.05, refine_sweeps: int = 16,
                    seed: int = 0) -> np.ndarray:
    """Locality-aware node -> part assignment (host-side, numpy only).

    Balanced multi-seed BFS growth followed by LDG-style refinement sweeps
    (Stanton & Kliot's linear deterministic greedy objective: move a node to
    the part holding most of its neighbours, damped by a balance cap). The
    JAX package's algorithm, line for line: the same seed gives the same
    assignment, bit for bit.

    Args:
      senders/receivers: int[E] directed edge endpoints (treated
        undirected for locality).
      balance: max part size as a multiple of num_nodes/num_parts.
      refine_sweeps: LDG refinement passes (each O(E) numpy).

    Returns int32[num_nodes] part ids, every part <= ceil(balance * N/P).
    """
    npart = int(num_parts)
    nn = int(num_nodes)
    if npart <= 1:
        return np.zeros(nn, np.int32)
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    u = np.concatenate([s, r])          # undirected incidence: u's neighbor
    v = np.concatenate([r, s])          # is v, both directions
    cap = int(np.ceil(nn / npart * balance))
    rng = np.random.default_rng(seed)
    parts = np.full(nn, -1, np.int32)
    seeds = rng.choice(nn, npart, replace=False)
    parts[seeds] = np.arange(npart, dtype=np.int32)
    sizes = np.bincount(parts[parts >= 0], minlength=npart).astype(np.int64)

    # --- balanced multi-source BFS growth -------------------------------
    while True:
        m = (parts[u] == -1) & (parts[v] >= 0)
        if not m.any():
            break
        uu = u[m]
        pv = parts[v[m]].astype(np.int64)
        frontier, inv = np.unique(uu, return_inverse=True)
        cf = np.bincount(inv * npart + pv,
                         minlength=len(frontier) * npart) \
            .reshape(-1, npart).astype(np.float64)
        # LDG score: neighbor pull damped by remaining capacity
        score = cf * np.maximum(1.0 - sizes / cap, 1e-9)[None, :]
        best = np.argmax(score, axis=1)
        assigned = 0
        for p in range(npart):
            sel = np.nonzero(best == p)[0]
            room = cap - int(sizes[p])
            if room <= 0 or len(sel) == 0:
                continue
            if len(sel) > room:
                sel = sel[np.argsort(-cf[sel, p], kind="stable")[:room]]
            parts[frontier[sel]] = p
            sizes[p] += len(sel)
            assigned += len(sel)
        if assigned == 0:
            # every candidate's best part is full: force the least-loaded
            # part (keeps the loop finite on adversarial degree skew)
            p = int(np.argmin(sizes))
            room = max(cap - int(sizes[p]), 1)
            sel = frontier[:room]
            parts[sel] = p
            sizes[p] += len(sel)
    rem = np.nonzero(parts == -1)[0]
    if len(rem):
        # isolated / disconnected leftovers: spread over least-loaded parts
        order = np.argsort(sizes, kind="stable")
        fill = np.concatenate([
            np.full(max(cap - int(sizes[p]), 0), p, np.int32)
            for p in order] + [np.zeros(0, np.int32)])
        if len(fill) < len(rem):    # caps too tight (rounding): round-robin
            extra = np.arange(len(rem) - len(fill)) % npart
            fill = np.concatenate([fill, extra.astype(np.int32)])
        parts[rem] = fill[:len(rem)]
        sizes = np.bincount(parts, minlength=npart).astype(np.int64)

    # --- LDG refinement sweeps ------------------------------------------
    floor = int(nn / npart * max(2.0 - balance, 0.5))
    ar = np.arange(nn)
    for _ in range(refine_sweeps):
        pv = parts[v].astype(np.int64)
        cnt = np.bincount(u * npart + pv, minlength=nn * npart) \
            .reshape(nn, npart)
        cur = parts.astype(np.int64)
        cur_cnt = cnt[ar, cur]
        best = np.argmax(cnt, axis=1)
        gain = cnt[ar, best] - cur_cnt
        cand = np.nonzero((gain > 0) & (best != cur))[0]
        if len(cand) == 0:
            break
        order = cand[np.argsort(-gain[cand], kind="stable")]
        moved = 0
        for p in range(npart):
            into = order[best[order] == p]
            room = cap - int(sizes[p])
            into = into[:max(room, 0)]
            if len(into) == 0:
                continue
            # don't drain any source part below the floor: keep only the
            # first (size_q - floor) departures per source part q
            src = parts[into]
            keep = np.ones(len(into), bool)
            for q in range(npart):
                idxq = np.nonzero(src == q)[0]
                allow = max(int(sizes[q]) - floor, 0)
                keep[idxq[allow:]] = False
            into = into[keep]
            if len(into) == 0:
                continue
            np.subtract.at(sizes, parts[into], 1)
            parts[into] = p
            sizes[p] += len(into)
            moved += len(into)
        if moved == 0:
            break
    return parts.astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionedGraph:
    """A graph's partition into ``num_parts`` parts, on the host (module
    docstring). Tuples hold one numpy array per part; the ``own_*`` and
    ``rem_*`` ones are None without the owned/remote split, the weights
    None for an unweighted graph.

    ``cut_stats`` (``int64[P, 4]``), per part: the cut edges into it (whose
    sender another part owns), its edges, the rows it ships to other parts,
    and (every row the same) the largest halo block ``len(halo[q][p])``
    over all pairs, at least 1: the JAX package's four columns.
    """

    num_parts: int
    num_nodes: int
    parts: np.ndarray
    owned: tuple
    recv_local: tuple
    send_buf: tuple
    edge_weight: tuple | None
    halo: tuple
    cut_stats: np.ndarray
    own_recv: tuple | None = None
    own_send: tuple | None = None
    own_weight: tuple | None = None
    rem_recv: tuple | None = None
    rem_send: tuple | None = None
    rem_weight: tuple | None = None
    # the REVERSED graph's partition, with the same node ownership (reverse
    # edges live on their receiver's = the original sender's part):
    # ShardGraph.reverse() swaps to its view
    reverse_pg: "PartitionedGraph | None" = None

    @property
    def split_local(self) -> bool:
        return self.own_recv is not None

    def buffer_rows(self, p: int) -> int:
        """Rows of part ``p``'s combined halo buffer."""
        return sum(len(self.halo[q][p]) for q in range(self.num_parts))

    @property
    def cut_fraction(self) -> float:
        """Fraction of edges whose sender lives on another part."""
        cs = self.cut_stats
        return float(cs[:, 0].sum() / max(cs[:, 1].sum(), 1))

    def halo_bytes_per_step(self, feat_dim: int, itemsize: int = 4) -> int:
        """Rows shipped between parts per exchange of a sender-side operand
        of ``feat_dim`` values of ``itemsize`` bytes, in bytes (all parts
        summed; a part's copy of its own rows is not counted)."""
        return int(self.cut_stats[:, 2].sum() * feat_dim * itemsize)

    def scatter_nodes(self, x) -> list:
        """``[N, ...]`` global node array (numpy or tensor) -> one array of
        each part's owned rows, ``[len(owned[p]), ...]``."""
        if hasattr(x, "index_select"):
            import torch
            return [x.index_select(0, torch.as_tensor(o, device=x.device))
                    for o in self.owned]
        x = np.asarray(x)
        return [x[o] for o in self.owned]

    def gather_nodes(self, xs):
        """Inverse of :meth:`scatter_nodes`: the parts' rows -> ``[N,
        ...]`` in global order (a tensor on the first part's device for
        tensors, else numpy)."""
        if hasattr(xs[0], "index_select"):
            import torch
            out = xs[0].new_zeros((self.num_nodes,) + tuple(xs[0].shape[1:]))
            for o, x in zip(self.owned, xs):
                out[torch.as_tensor(o, device=out.device)] = x.to(out.device)
            return out
        xs = [np.asarray(x) for x in xs]
        out = np.zeros((self.num_nodes,) + xs[0].shape[1:], xs[0].dtype)
        for o, x in zip(self.owned, xs):
            out[o] = x
        return out


def _range_parts(nn: int, num_parts: int) -> np.ndarray:
    """Balanced contiguous ranges of node ids (the JAX package's default)."""
    bounds = np.linspace(0, nn, num_parts + 1).astype(np.int64)
    parts = np.zeros(nn, np.int32)
    for p in range(num_parts):
        parts[bounds[p]:bounds[p + 1]] = p
    return parts


def _partition(s, r, w, nn: int, num_parts: int, parts: np.ndarray,
               split_local: bool) -> PartitionedGraph:
    """Partition the edges ``s -> r`` (receiver-sorted) by ``parts``."""
    P = num_parts
    owned = tuple(np.nonzero(parts == p)[0] for p in range(P))
    glob2loc = np.zeros(nn, np.int64)
    for o in owned:
        glob2loc[o] = np.arange(len(o))
    e_part = parts[r].astype(np.int64)
    by_part = np.argsort(e_part, kind="stable")
    bounds = np.searchsorted(e_part[by_part], np.arange(P + 1))
    edges_of = [by_part[bounds[p]:bounds[p + 1]] for p in range(P)]

    recv_local, send_buf, weights = [], [], []
    halo = [[None] * P for _ in range(P)]
    split = {k: [] for k in ("own_recv", "own_send", "own_weight",
                             "rem_recv", "rem_send", "rem_weight")}
    cut = np.zeros(P, np.int64)
    for p, eidx in enumerate(edges_of):
        ss = s[eidx]
        qs = parts[ss].astype(np.int64)
        # senders keyed part * nn + local id: the sorted unique keys are the
        # halo blocks in part order, ascending ids within a block, and a
        # sender's rank among them its row of the buffer
        key = qs * nn + glob2loc[ss]
        uniq = np.unique(key)
        pos = np.searchsorted(uniq, key)
        block = uniq // nn
        for q in range(P):
            halo[q][p] = uniq[block == q] % nn
        rl = glob2loc[r[eidx]]
        recv_local.append(rl)
        send_buf.append(pos)
        we = None if w is None else w[eidx]
        weights.append(we)
        own = qs == p
        cut[p] = int((~own).sum())
        if split_local:
            uniq_rem = uniq[block != p]
            split["own_recv"].append(rl[own])
            split["own_send"].append(glob2loc[ss[own]])
            split["rem_recv"].append(rl[~own])
            split["rem_send"].append(np.searchsorted(uniq_rem, key[~own]))
            split["own_weight"].append(None if we is None else we[own])
            split["rem_weight"].append(None if we is None else we[~own])
    h_min = max([1] + [len(halo[q][p]) for q in range(P) for p in range(P)])
    cut_stats = np.array(
        [[cut[p], len(edges_of[p]),
          sum(len(halo[p][q]) for q in range(P) if q != p), h_min]
         for p in range(P)], np.int64).reshape(P, 4)
    kw = {}
    if split_local:
        kw = {k: (None if k.endswith("weight") and w is None else tuple(v))
              for k, v in split.items()}
    return PartitionedGraph(
        num_parts=P, num_nodes=nn, parts=parts, owned=owned,
        recv_local=tuple(recv_local), send_buf=tuple(send_buf),
        edge_weight=None if w is None else tuple(weights),
        halo=tuple(tuple(row) for row in halo), cut_stats=cut_stats, **kw)


def partition_graph(g, num_parts: int, *, parts=None,
                    with_reverse: bool = False,
                    split_local: bool = True) -> PartitionedGraph:
    """Partition a graph for one-process-per-part message passing.

    ``g`` is a :class:`~..graph.GraphTuple` (on any device: its edges are
    read to the host once). ``parts``: None (balanced contiguous ranges of
    ids, which keep whatever locality the ordering has), ``"bfs"``
    (:func:`partition_nodes`) or an ``int[num_nodes]`` assignment.
    ``with_reverse`` also partitions the reversed graph with the same
    ownership (``reverse_pg``: DConv, ``degree(dir="out")`` on a part's
    view); ``split_local`` adds the owned/remote edge split.
    """
    nn = int(g.num_nodes)
    s = g.senders.detach().cpu().numpy().astype(np.int64)
    r = g.receivers.detach().cpu().numpy().astype(np.int64)
    w = (None if g.edge_weight is None
         else g.edge_weight.detach().cpu().numpy())
    if g.eid_r is not None:
        raise ValueError("partition_graph takes a graph in receiver order, "
                         "not a reversed one (GraphTuple.reverse)")
    if isinstance(parts, str):
        if parts != "bfs":
            raise ValueError(f"unknown partitioner {parts!r} "
                             "(use 'bfs' or pass an explicit assignment)")
        parts = partition_nodes(s, r, nn, num_parts)
    parts = (_range_parts(nn, num_parts) if parts is None
             else np.asarray(parts, np.int32))
    if parts.shape != (nn,) or (nn and (parts.min() < 0
                                        or parts.max() >= num_parts)):
        raise ValueError(f"parts must be int[{nn}] ids in [0, {num_parts})")
    pg = _partition(s, r, w, nn, num_parts, parts, split_local)
    if with_reverse:
        # the reversed edges in receiver order (a stable sort by the
        # original sender), as graph() stores them
        order = np.argsort(s, kind="stable")
        rev = _partition(r[order], s[order], None if w is None else w[order],
                         nn, num_parts, parts, split_local)
        pg = dataclasses.replace(pg, reverse_pg=rev)
    return pg
