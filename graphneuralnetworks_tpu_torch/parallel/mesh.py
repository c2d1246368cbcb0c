"""A device mesh over ``torch.distributed``: one process per mesh point.

The JAX package names its axes on a ``jax.sharding.Mesh`` and runs one
``shard_map`` program over it. Here every mesh point is a process (a rank
of the default group, in row-major order over the axes), and each axis is
a set of process groups: the ranks that differ only in that coordinate.
A rank's group of an axis orders its members by that coordinate, so group
rank ``k`` is the point at coordinate ``k``: ``all_to_all_single`` over the
``graph`` group sends block ``k`` to part ``k``.

The caller starts the processes and ``torch.distributed.init_process_group``
(address, world size, rank and backend: ``gloo`` for CPU tensors and for
several ranks sharing one card, ``nccl`` for one card per rank); the mesh
reads them and creates its groups with ``dist.new_group``, which every
rank calls in the same order.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

__all__ = ["Mesh"]


class Mesh:
    """``Mesh((2, 2), ("data", "graph"))``: this rank's coordinates and its
    process group along each named axis. The product of ``shape`` must be
    the world size."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(v) for v in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        rank = dist.get_rank()
        self.coords = dict(zip(axis_names, _unravel(rank, shape)))
        self._groups = {}
        for i, axis in enumerate(axis_names):
            others = [range(n) for j, n in enumerate(shape) if j != i]
            for rest in itertools.product(*others):
                ranks = [_ravel(rest[:i] + (k,) + rest[i:], shape)
                         for k in range(shape[i])]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axis] = group

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._axis(axis)]

    def size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[self._axis(axis)]

    def _axis(self, axis: str) -> str:
        if axis not in self.shape:
            raise ValueError(f"the mesh has no axis {axis!r} (its axes: "
                             f"{self.axis_names})")
        return axis

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank at {self.coords})"


def _ravel(coords, shape) -> int:
    rank = 0
    for c, n in zip(coords, shape):
        rank = rank * n + c
    return rank


def _unravel(rank: int, shape) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))
