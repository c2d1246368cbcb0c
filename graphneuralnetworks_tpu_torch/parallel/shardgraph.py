"""ShardGraph: one part's graph view, which runs the port's layers unchanged.

Counterpart of ``graphneuralnetworks_tpu/parallel/shardgraph.py``. Each
process holds one part of a :class:`~.partition.PartitionedGraph` and builds
its view once, on its device (:func:`shard_graph_local`). The view is a
:class:`~..graph.GraphTuple` whose receivers are the part's owned nodes
(``num_nodes`` = their count) and whose senders index the HALO BUFFER: the
rows of every part that this part's edges read, block by block. It is the
hetero relation's pattern (``heterograph.py``): the receiver CSR holds
``num_nodes`` rows, the sender CSR the buffer's, and K1 reads a source of
other rows than it writes.

A sender-side node array goes into the buffer through :meth:`ShardGraph.
src_space`: one ``all_to_all_single`` over the part's process group ships
exactly the rows each part needs, in uneven blocks (communication = the
edge cut, not O(N)). ``ops.to_src_space`` calls it wherever the ops read a
node array by sender, and decides "not yet converted" by the leading
dimension (``num_nodes``), so a buffer may never have that many rows: a
part whose buffer would has one unreferenced zero row appended.

Every part owns ALL in-edges of its nodes, so everything receiver-keyed is
local math: in-degree, segment mean/max/min, the per-receiver softmax of
GAT with its virtual self-loops. That is why GCNConv, SAGEConv and GATConv
give the single-device result. ``degree(dir="out")`` and ``g.reverse()``
(DConv) read the reversed partition's view (``with_reverse=True``).

Gradients: :class:`_AllToAll`'s backward is the same exchange with the
split sizes swapped, and the gather of the shipped rows is a
:func:`~..ops.cuda.gather.fast_gather` over their grouping by node, whose
backward is K1: a node shipped to several parts sums its cotangents in a
fixed order, so a step gives the same bits every time. Every process must
run its forward and ``backward()`` through the same sequence of
exchanges, as the same layer code on every part does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..graph import GraphTuple, group_by
from ..ops.cuda.gather import fast_gather
from .partition import PartitionedGraph

__all__ = ["ShardGraph", "shard_graph_local", "local_graph"]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of the rows of ``send``, block ``q`` of
    ``send_splits[q]`` rows to group rank ``q``, receiving ``recv_splits[q]``
    rows from each into a buffer with ``pad`` zero rows after them; its
    backward sends the received rows' cotangents back the same way."""

    @staticmethod
    def forward(ctx, send, send_splits, recv_splits, group, pad):
        ctx.splits = (send_splits, recv_splits, group)
        return _exchange(send, send_splits, recv_splits, group, pad)

    @staticmethod
    def backward(ctx, dout):
        send_splits, recv_splits, group = ctx.splits
        dout = dout[:sum(recv_splits)]
        return (_exchange(dout, recv_splits, send_splits, group, 0),
                None, None, None, None)


def _exchange(send, send_splits, recv_splits, group, pad):
    send = send.contiguous()
    rows = sum(recv_splits)
    out = send.new_empty((rows + pad,) + tuple(send.shape[1:]))
    out[rows:].zero_()
    dist.all_to_all_single(out[:rows], send, list(recv_splits),
                           list(send_splits), group=group)
    return out


class Halo:
    """One part's halo exchange: the rows ``send_idx`` of its ``n_owned``
    (block ``q`` for group rank ``q``, ``send_splits[q]`` rows), the blocks
    received (``recv_splits``) and ``pad`` zero rows appended.

    With the gloo backend the exchange takes CUDA tensors itself (gloo
    stages them through the host); nccl moves them card to card.
    """

    def __init__(self, send_idx: torch.Tensor, n_owned: int, send_splits,
                 recv_splits, group, pad: int = 0):
        self.send_idx = send_idx
        # the shipped rows grouped by node: fast_gather's K1 backward
        _, order, self.indptr = group_by(send_idx, n_owned)
        self.col = order.int()
        self.send_splits = [int(v) for v in send_splits]
        self.recv_splits = [int(v) for v in recv_splits]
        self.group = group
        self.pad = int(pad)

    @property
    def rows(self) -> int:
        """Rows of the buffer: the blocks received and the padding."""
        return sum(self.recv_splits) + self.pad

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        rows = fast_gather(v.reshape(v.shape[0], -1), self.send_idx,
                           self.indptr, self.col)
        return _AllToAll.apply(rows.reshape((-1,) + tuple(v.shape[1:])),
                               self.send_splits, self.recv_splits, self.group,
                               self.pad)


def local_graph(recv, send, n_dst: int, n_src: int, *, edge_weight=None,
                device=None, cls=GraphTuple, **extra) -> GraphTuple:
    """A graph of the edges ``send -> recv`` (numpy, receiver-sorted) whose
    receiver CSR has ``n_dst`` rows and whose sender CSR has ``n_src`` (the
    rows of the source it reads), built on ``device``; ``num_nodes`` is
    ``n_dst``. Both groupings come from :func:`~..graph.group_by`."""
    device = resolve_device(device)
    r = torch.as_tensor(np.asarray(recv, np.int64), device=device)
    s = torch.as_tensor(np.asarray(send, np.int64), device=device)
    ne = int(r.numel())
    r_sorted, order, indptr_r = group_by(r, n_dst)
    s_sorted = s.int()[order]
    _, by_s, indptr_s = group_by(s_sorted, n_src)
    w = None
    if edge_weight is not None:
        w = torch.as_tensor(np.asarray(edge_weight), device=device)[order]
    return cls(
        senders=s_sorted.long(), receivers=r_sorted.long(), num_nodes=n_dst,
        num_edges=ne, num_graphs=1,
        node_graph_id=torch.zeros(n_dst, dtype=torch.int64, device=device),
        indptr_r=indptr_r, col_r=s_sorted, indptr_s=indptr_s,
        col_s=r_sorted[by_s], eid_s=by_s.int(), edge_weight=w,
        indptr_g=torch.tensor([0, n_dst], dtype=torch.int32, device=device),
        indptr_ge=torch.tensor([0, ne], dtype=torch.int32, device=device),
        **extra)


@dataclasses.dataclass(frozen=True)
class _Split:
    """The owned/remote edge split of a part: ``own`` reads the owned rows
    themselves, ``rem`` the buffer of the other parts' blocks (``halo``)."""

    own: GraphTuple
    rem: GraphTuple
    halo: Halo


@dataclasses.dataclass(frozen=True)
class ShardGraph(GraphTuple):
    """One part's view (module docstring): a GraphTuple over the owned nodes
    whose senders index the halo buffer of ``halo.rows`` rows."""

    halo: Halo | None = None
    split: _Split | None = None
    reverse_view: "ShardGraph | None" = None

    @property
    def src_rows(self) -> int:
        """Rows of the halo buffer: the sender index space."""
        return self.indptr_s.numel() - 1

    def src_space(self, v: torch.Tensor) -> torch.Tensor:
        """Owned-node array ``[num_nodes, ...]`` -> halo buffer
        ``[src_rows, ...]``: one exchange over the part's group."""
        return self.halo(v)

    def reverse(self) -> "ShardGraph":
        """The reversed graph's view (same owned nodes, the reverse edges
        on their receiver's part), sharing this view's node features.
        Needs ``partition_graph(..., with_reverse=True)``."""
        if self.reverse_view is None:
            raise NotImplementedError(
                "ShardGraph.reverse: partition the graph with "
                "partition_graph(..., with_reverse=True) to enable "
                "reverse-direction propagation across parts")
        return self.reverse_view.replace(nodes=self.nodes)

    def __repr__(self) -> str:
        return (f"ShardGraph(num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges}, src_rows={self.src_rows}, "
                f"device={self.device}, nodes={list(self.nodes)})")


def _halo(pg: PartitionedGraph, part: int, group, device, *,
          remote: bool = False) -> Halo:
    """Part ``part``'s exchange: every block, or with ``remote`` the
    off-diagonal ones only. Pads the combined buffer by one zero row where
    its rows would equal the owned count (module docstring)."""
    P = pg.num_parts
    keep = [q for q in range(P) if not (remote and q == part)]
    send = np.concatenate([np.zeros(0, np.int64)]
                          + [pg.halo[part][q] for q in keep])
    send_splits = [len(pg.halo[part][q]) if q in keep else 0
                   for q in range(P)]
    recv_splits = [len(pg.halo[q][part]) if q in keep else 0
                   for q in range(P)]
    n_own = len(pg.owned[part])
    pad = int(not remote and sum(recv_splits) == n_own)
    return Halo(torch.as_tensor(send, device=device), n_own, send_splits,
                recv_splits, group, pad)


def shard_graph_local(pg: PartitionedGraph, part: int, group=None, *,
                      device=None, split: bool = False) -> ShardGraph:
    """Build part ``part``'s :class:`ShardGraph` on ``device`` (``None``:
    the CUDA card). ``group`` is the process group whose ranks ``0 ..
    P-1`` hold parts ``0 .. P-1`` (``None``: the default group). With
    ``split`` and a partition made with ``split_local``, the view also
    holds the owned/remote edge split (``view.split``) that only
    ``halo_propagate_local`` reads; the layers never do."""
    device = resolve_device(device)
    if dist.get_world_size(group) != pg.num_parts:
        raise ValueError(f"the group has {dist.get_world_size(group)} ranks "
                         f"for {pg.num_parts} parts")
    n_own = len(pg.owned[part])
    halo = _halo(pg, part, group, device)
    split_view = None
    if split and pg.split_local:
        rem = _halo(pg, part, group, device, remote=True)
        wt = pg.own_weight is not None
        split_view = _Split(
            own=local_graph(pg.own_recv[part], pg.own_send[part], n_own,
                            n_own, device=device,
                            edge_weight=pg.own_weight[part] if wt else None),
            rem=local_graph(pg.rem_recv[part], pg.rem_send[part], n_own,
                            rem.rows, device=device,
                            edge_weight=pg.rem_weight[part] if wt else None),
            halo=rem)
    rev = None
    if pg.reverse_pg is not None:
        rev = shard_graph_local(pg.reverse_pg, part, group, device=device)
    return local_graph(
        pg.recv_local[part], pg.send_buf[part], n_own, halo.rows,
        edge_weight=None if pg.edge_weight is None else pg.edge_weight[part],
        device=device, cls=ShardGraph, halo=halo, split=split_view,
        reverse_view=rev)
