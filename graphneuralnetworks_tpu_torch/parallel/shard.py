"""Edge-partitioned message passing and training, one process per part.

Counterpart of ``graphneuralnetworks_tpu/parallel/shard.py``. Each part owns
a node set and the edges into it; one exchange over the ``graph`` axis's
process group ships exactly the boundary rows each part needs (the halo of
``partition.py``), then K1 aggregates locally. With the partition's
owned/remote edge split (the default), the owned half reads ``x_local``
itself: two K1 launches, one before the exchange and one after it
(:func:`_halo_propagate_split`). Data parallelism over several partitioned
graphs composes on a ``data`` axis (:func:`make_mesh_train_step`).

Gradients flow through the exchange by its autograd function, whose
backward is the exchange with the split sizes swapped
(``shardgraph._AllToAll``); the parameters' gradients are then summed over
every rank (:func:`all_reduce_grads`).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.cuda.spmm import spmm
from .mesh import Mesh
from .partition import PartitionedGraph
from .shardgraph import ShardGraph, shard_graph_local

__all__ = ["halo_propagate_local", "make_sharded_propagate",
           "make_sharded_apply", "make_mesh_train_step", "all_reduce_grads"]


def halo_propagate_local(x_local: torch.Tensor,
                         sg: ShardGraph) -> torch.Tensor:
    """One part's ``propagate(copy_xj | w_mul_xj, +)``: ``[num_nodes, D]``
    owned rows in, aggregated owned rows out, weighted by the graph's own
    weights if it has them.

    On a view that holds the owned/remote split (``partition_graph(
    split_local=True)``, the default, seen through
    :func:`make_sharded_propagate` or ``shard_graph_local(..., split=True)``),
    :func:`_halo_propagate_split`; on any other view (or on
    ``sg.replace(split=None)``) the combined path: one exchange of every
    block into the halo buffer, then K1 over the part's edges.
    """
    if sg.split is not None:
        return _halo_propagate_split(x_local, sg)
    return spmm(sg, sg.src_space(x_local),
                weighted=sg.edge_weight is not None)


def _halo_propagate_split(x_local: torch.Tensor, sg: ShardGraph):
    """``y = sum_own w_e x_local[s_e] + sum_rem w_e buf[s_e]``: K1 over the
    owned edges from ``x_local``, the exchange of the off-diagonal blocks
    alone, then K1 over the remote edges from the buffer. The exchange is
    issued after the owned K1 is queued, not overlapped with it. The two
    halves add in another order than the combined path's one sum, so the
    paths agree to rounding, not bit for bit."""
    split = sg.split
    y = spmm(split.own, x_local,
             weighted=split.own.edge_weight is not None)
    buf = split.halo(x_local)
    return y + spmm(split.rem, buf,
                    weighted=split.rem.edge_weight is not None)


def _part_graph(mesh: Mesh, pg, axis: str, data_axis, device,
                split: bool = False) -> ShardGraph:
    """This rank's view: its replica's partition (``pg[data index]`` when
    ``data_axis`` is set) at its coordinate along ``axis``, with the
    owned/remote split if ``split``."""
    if data_axis is not None:
        if not isinstance(pg, (list, tuple)) or len(pg) != mesh.size(
                data_axis):
            raise ValueError(f"with data_axis={data_axis!r}, pass one "
                             "PartitionedGraph per replica, as a list of "
                             f"{mesh.size(data_axis)}")
        pg = pg[mesh.index(data_axis)]
    if not isinstance(pg, PartitionedGraph):
        raise TypeError(f"expected a PartitionedGraph, got {type(pg)}")
    return shard_graph_local(pg, mesh.index(axis), mesh.group(axis),
                             device=device, split=split)


def _sharded(mesh: Mesh, pg, fn: Callable, axis: str, device,
             split: bool) -> Callable:
    """``run(*a, **kw) = fn(sg, *a, **kw)`` over this rank's view ``sg``,
    built once (``run.graph``)."""
    sg = _part_graph(mesh, pg, axis, None, resolve_device(device), split)

    def run(*args, **kw):
        return fn(sg, *args, **kw)

    run.graph = sg
    return run


def make_sharded_propagate(mesh: Mesh, pg: PartitionedGraph,
                           axis: str = "graph", *, device=None) -> Callable:
    """``run(x_local [num_nodes, D]) -> [num_nodes, D]``: this rank's part
    of the halo propagate (:func:`halo_propagate_local`) over ``mesh``'s
    ``axis``. The part's view is built once, on ``device`` (``None``: the
    CUDA card), with the owned/remote split where the partition has one,
    and is ``run.graph``."""
    return _sharded(mesh, pg, lambda sg, x: halo_propagate_local(x, sg),
                    axis, device, split=True)


def make_sharded_apply(mesh: Mesh, pg: PartitionedGraph, fn: Callable,
                       axis: str = "graph", *, device=None) -> Callable:
    """Run an UNMODIFIED layer or model on this rank's part:
    ``run(x_own, *args) = fn(sg, x_own, *args)``, ``sg`` this part's
    :class:`~.shardgraph.ShardGraph` (built once: ``run.graph``) and
    ``x_own`` its owned rows. Every sender-side operand rides one exchange.

    Gradients reach ``x_own`` and the parameters ``fn`` uses through the
    exchanges. A parameter's ``.grad`` on one rank is that rank's share:
    :func:`all_reduce_grads` sums them into the gradient of the sum of the
    parts' losses.
    """
    return _sharded(mesh, pg, fn, axis, device, split=False)


def all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's ``.grad`` over ``group`` (``None``: all
    ranks) in one ``all_reduce`` of their concatenation; a missing
    gradient counts as zeros and is set, so every rank sends the same
    layout."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p).clone()
        at += n


def make_mesh_train_step(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer, mesh: Mesh, pg,
                         local_loss: Callable, *,
                         data_axis: str | None = "data",
                         graph_axis: str = "graph", device=None) -> Callable:
    """Data parallelism over partitioned graphs composed with edge-
    partitioned message passing, as one train step per rank.

    Args:
      model: a module (e.g. ``models.GNNChain``), replicated: its
        parameters and buffers are broadcast from rank 0 here.
      optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters.
      mesh: a :class:`~.mesh.Mesh` with ``graph_axis`` and, unless
        ``data_axis=None``, ``data_axis``.
      pg: one :class:`~.partition.PartitionedGraph`, or with ``data_axis``
        a list of one per replica (replica ``i`` at data coordinate ``i``).
      local_loss: ``local_loss(model, sg, *batch) -> (loss_sum, weight)``,
        this part's un-normalised loss and its weight (e.g. the masked node
        count). The step minimises ``sum(loss_sum) / max(sum(weight), 1)``
        over all ranks.

    Returns ``step(*batch) -> loss`` (the global loss, a detached tensor),
    with ``batch`` this rank's tensors (e.g. ``pg.scatter_nodes(x)[part]``)
    and the part's view ``step.graph``.

    Why summing the parameter gradients over all ranks gives the gradient
    of the global loss ``L = sum_i loss_sum_i / W`` (``W`` the summed
    weight, a count that carries no gradient): rank ``i`` back-propagates
    ``L_i = loss_sum_i / W``. Each exchange's backward hands the cotangents
    of the rows other ranks received back to the rank that sent them, so
    when all ranks have run ``backward()`` every computation was reached by
    the cotangent of ``L = sum_i L_i`` flowing into its outputs, whichever
    rank's loss it fed. A parameter's ``.grad`` on rank ``i`` then holds
    the terms of ``dL/dθ`` from the computations rank ``i`` ran, and the
    sum over ranks is ``dL/dθ`` itself: the JAX package's pmean of
    ``N/W · ds_i/dθ`` (``shard.py:282-290``), the same gradient on every
    rank, so every replica takes the same optimizer step.
    """
    if data_axis is not None:
        mesh._axis(data_axis)
    device = resolve_device(device)
    sg = _part_graph(mesh, pg, graph_axis, data_axis, device)
    for t in [*model.parameters(), *model.buffers()]:
        dist.broadcast(t.data, src=0)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss_sum, weight = local_loss(model, sg, *batch)
        tot = torch.stack([loss_sum.detach(),
                           torch.as_tensor(weight, dtype=loss_sum.dtype,
                                           device=loss_sum.device)])
        dist.all_reduce(tot)
        denom = tot[1].clamp(min=1.0)
        (loss_sum / denom).backward()
        all_reduce_grads(params)
        optimizer.step()
        return tot[0] / denom

    step.graph = sg
    return step
