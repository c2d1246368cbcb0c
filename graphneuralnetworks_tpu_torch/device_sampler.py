"""Fixed-fanout neighbor sampling on the card: GraphSAGE minibatches with
no per-batch host work and no host->device index traffic.

Counterpart of ``graphneuralnetworks_tpu/device_sampler.py`` (the layered
fixed-fanout semantics of GNNGraphs/src/samplers.jl:28-105 with
sampling.jl:68-118's ``replace``). With fixed fanouts and no dedup, the
sampled subgraph's structure in slot space is the same for every batch:
node slot ``i`` of layer ``l`` receives from slots ``off_{l+1} + i*k ..
off_{l+1} + (i+1)*k - 1``. Only the slot -> node map (``NID``) and which
edges are valid change. So:

- the structural slot graph and the per-model-layer blocks, with both CSR
  groupings, are built once by :meth:`DeviceSampler.build`, with no sort:
  receivers ascend by construction and so do senders (each slot past the
  seeds is the sender of exactly one edge, in edge order), so the sender
  grouping's positions are the edge ids (``eid_s`` None);
- per batch, :meth:`~DeviceSampler.sample` gathers neighbor ids out of the
  card-resident CSR (``csr_send`` and ``lo_deg``, the ``(row start,
  degree)`` pairs) from one uniform draw per slot edge;
- the batch carries ``edge_valid`` (``graph.py``): the slots below a node
  with no in-edges, and, without replacement, those past a node's degree,
  are invalid and echo their parent's id, so feature gathers stay in range.
  K1 takes the validity as 0/1 weights and mean divides by the valid count.

Randomness: JAX draws ``jax.random.uniform(key, (e_total,))``, whose bits
PyTorch cannot reproduce; the port draws ``torch.rand(e_total)`` from a
``torch.Generator`` on the sampler's device. The draw's semantics are the
same (``tests/test_torch_device_sampler.py``), and fed JAX's draw
(:meth:`~DeviceSampler.graph_of`, :meth:`~DeviceSampler.blocks_of`) the
port computes JAX's numbers.

Usage::

    sampler = DeviceSampler.build(csr_send, ptr, fanouts=(15, 10),
                                  batch_size=1024)
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks, nid = sampler.sample_blocks(gen, seeds)   # seeds on the card
    h = apply_blocks(blocks, convs, X[nid])
    logits = head(h[:sampler.batch_size])
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .graph import GraphTuple

__all__ = ["DeviceSampler", "apply_blocks"]


def apply_blocks(blocks, layers, x):
    """Thread features through per-hop blocks: ``x = layer(blk,
    x[:blk.num_nodes])``.

    ``blocks`` from :meth:`DeviceSampler.sample_blocks`; ``layers`` the
    model's conv layers in application order. Each block's node space
    shrinks to the rows the next layer reads.
    """
    for blk, layer in zip(blocks, layers):
        x = layer(blk, x[:blk.num_nodes])
    return x


def _slot_graph(r: np.ndarray, n_nodes: int, first_sender: int,
                device) -> GraphTuple:
    """The GraphTuple of slot edges ``first_sender + t -> r[t]`` over
    ``n_nodes`` slots, ``r`` non-decreasing: both groupings from counts,
    with no sort."""
    ne = len(r)
    s = first_sender + np.arange(ne, dtype=np.int64)
    indptr_r = np.searchsorted(r, np.arange(n_nodes + 1)).astype(np.int32)
    # sender slot v (>= first_sender) sends edge v - first_sender only
    indptr_s = np.clip(np.arange(n_nodes + 1) - first_sender, 0,
                       ne).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GraphTuple(
        senders=dev(s), receivers=dev(r.astype(np.int64)), num_nodes=n_nodes,
        num_edges=ne, num_graphs=1,
        node_graph_id=torch.zeros(n_nodes, dtype=torch.int64, device=device),
        indptr_r=dev(indptr_r), col_r=dev(s.astype(np.int32)),
        indptr_s=dev(indptr_s), col_s=dev(r.astype(np.int32)), eid_s=None,
        indptr_g=dev(np.array([0, n_nodes], np.int32)),
        indptr_ge=dev(np.array([0, ne], np.int32)))


@dataclasses.dataclass(frozen=True)
class DeviceSampler:
    """Fixed-fanout layered sampler executed on the card (module
    docstring). Construct with :meth:`build`."""

    csr_send: torch.Tensor     # int32[E] senders grouped by receiver
    lo_deg: torch.Tensor       # int32[N, 2] (row start, in-degree)
    graph: GraphTuple          # the structural slot graph, all layers
    # per-model-layer blocks: block j has the edges of sample layers
    # 1..L-j over the slots those reach (static structure; NID and
    # edge_valid are filled per batch)
    blocks: tuple
    fanouts: tuple
    batch_size: int
    num_nodes: int
    n_slots: int
    e_total: int
    replace: bool = True

    @property
    def senders(self) -> torch.Tensor:
        return self.graph.senders

    @property
    def receivers(self) -> torch.Tensor:
        return self.graph.receivers

    @property
    def block_sizes(self) -> tuple:
        """``(num_edges, num_nodes)`` of each block (JAX's ``(E_j,
        n_in_j)``)."""
        return tuple((b.num_edges, b.num_nodes) for b in self.blocks)

    @property
    def device(self) -> torch.device:
        return self.csr_send.device

    @classmethod
    def build(cls, csr_send, ptr, *, fanouts, batch_size: int,
              replace: bool = True, device=None) -> "DeviceSampler":
        """Derive the structural slot graph and its blocks and place them
        and the CSR on ``device`` (default: the card).

        ``csr_send[ptr[v]:ptr[v+1]]`` must list the in-neighbors (senders)
        of node ``v``: the layout ``NeighborLoader.csr`` gives. Both may be
        numpy arrays or tensors; a tensor already on ``device`` is not
        copied.
        """
        fanouts = tuple(int(k) for k in fanouts)
        if not fanouts or any(k <= 0 for k in fanouts):
            raise ValueError(f"fanouts must be positive, got {fanouts}")
        device = resolve_device(device)
        csr_send = torch.as_tensor(csr_send)
        ptr = torch.as_tensor(ptr)
        num_nodes = int(ptr.shape[0]) - 1
        if int(ptr[-1]) != csr_send.shape[0]:
            raise ValueError("ptr[-1] != len(csr_send)")
        if csr_send.shape[0] >= 2**31:
            raise ValueError("CSR too large for int32 pointers")

        # layer sizes and slot offsets: L0 seeds, L_i = L_{i-1} * k_i
        sizes = [int(batch_size)]
        for k in fanouts:
            sizes.append(sizes[-1] * k)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        n_slots = int(offs[-1])
        e_total = n_slots - sizes[0]
        # structural edges, layer-major: layer i's edge j has the parent
        # slot offs[i] + j // k as receiver and slot offs[i+1] + j as sender
        r = np.concatenate([offs[i] + np.repeat(np.arange(sizes[i]), k)
                            for i, k in enumerate(fanouts)])
        L = len(fanouts)
        # model conv j only needs output rows for slots of depth <= L-j-1
        # and the edge prefix of sample layers 1..L-j; it outputs the rows
        # of every slot it reads, as JAX's blocks do
        blocks = []
        for j in range(L):
            n_in = int(offs[L - j + 1])
            blocks.append(_slot_graph(r[:n_in - sizes[0]], n_in, sizes[0],
                                      device))
        ptr = ptr.to(device)
        lo_deg = torch.stack([ptr[:-1], torch.diff(ptr)], 1).int()
        return cls(csr_send=csr_send.to(device, torch.int32),
                   lo_deg=lo_deg.contiguous(), graph=blocks[0],
                   blocks=tuple(blocks), fanouts=fanouts,
                   batch_size=int(batch_size), num_nodes=num_nodes,
                   n_slots=n_slots, e_total=e_total, replace=bool(replace))

    def graph_of(self, nid: torch.Tensor, edge_valid: torch.Tensor
                 ) -> GraphTuple:
        """The slot graph of one draw: ``nid`` ``[n_slots]`` slot -> node
        ids, ``edge_valid`` ``[e_total]``."""
        return self.graph.replace(nodes={"NID": nid}, edge_valid=edge_valid)

    def blocks_of(self, nid: torch.Tensor, edge_valid: torch.Tensor
                  ) -> tuple:
        """The per-model-layer blocks of one draw: block ``j`` takes the
        first ``num_nodes`` slots and ``num_edges`` edges."""
        return tuple(b.replace(nodes={"NID": nid[:b.num_nodes]},
                               edge_valid=edge_valid[:b.num_edges])
                     for b in self.blocks)

    def sample(self, generator: torch.Generator, seeds) -> GraphTuple:
        """Draw one fixed-fanout batch on the card.

        ``seeds``: ``[batch_size]`` seed node ids (duplicates allowed), on
        the sampler's device. Returns the slot graph with
        ``nodes["NID"]`` (int32 ``[n_slots]``, seeds first) and
        ``edge_valid``.
        """
        return self.graph_of(*self._draw(generator, seeds))

    def sample_blocks(self, generator: torch.Generator, seeds) -> tuple:
        """Like :meth:`sample`, but returns ``(blocks, nid)``: ``blocks[j]``
        is the graph model conv ``j`` runs on (thread them with
        :func:`apply_blocks`), ``nid`` the slot -> node map (gather the
        features once: ``X[nid]``). The same numbers as :meth:`sample` on
        the rows that matter, with k-fold less work at depth > 1."""
        nid, ev = self._draw(generator, seeds)
        return self.blocks_of(nid, ev), nid

    def _draw(self, generator, seeds):
        """Core layered draw: ``(nid [n_slots], edge_valid [e_total])``."""
        if tuple(seeds.shape) != (self.batch_size,):
            raise ValueError(f"seeds shape {tuple(seeds.shape)} != "
                             f"({self.batch_size},)")
        dev = self.device
        nid_layers = [seeds.to(dev, torch.int32)]
        valid_prev = torch.ones(self.batch_size, dtype=torch.bool,
                                device=dev)
        evalid = []
        # one draw for every layer's uniforms
        u_all = torch.rand(self.e_total, generator=generator, device=dev)
        pos = 0
        for k in self.fanouts:
            parents = nid_layers[-1]
            v = parents.repeat_interleave(k)                 # [L_i]
            pv = valid_prev.repeat_interleave(k)
            pair = self.lo_deg[v.long()]                     # [L_i, 2]
            lo, deg = pair[:, 0], pair[:, 1]
            u = u_all[pos:pos + v.shape[0]]
            pos += v.shape[0]
            zero = torch.zeros_like(deg)
            if self.replace:
                # floor(u*deg) rounds up to deg in f32 near u -> 1: clamp
                idx = torch.minimum((u * deg).int(),
                                    torch.maximum(deg - 1, zero))
                val = pv & (deg > 0)
            else:
                n_par = parents.shape[0]
                degp = self.lo_deg[parents.long(), 1]        # [P]
                uk = u.reshape(n_par, k)
                # Floyd's algorithm, k unrolled: step j draws t ~ U[0,
                # d-k+j+1); if t is already picked it keeps d-k+j instead.
                # Valid only when d >= k; parents with d <= k take all d
                # neighbors (slots j >= d invalid below).
                picked = torch.full((n_par, k), -1, dtype=torch.int32,
                                    device=dev)
                for j in range(k):
                    rng_j = torch.clamp(degp - k + j + 1, min=1)
                    t = torch.minimum((uk[:, j] * rng_j).int(), rng_j - 1)
                    coll = (picked == t[:, None]).any(1)
                    picked[:, j] = torch.where(coll, degp - k + j, t)
                seq = torch.arange(k, dtype=torch.int32,
                                   device=dev).expand(n_par, k)
                idx = torch.where((degp > k)[:, None], picked, seq)
                # invalid slots (j >= d) may index past the node's range;
                # clamp so the (discarded) CSR read stays in its rows
                idx = torch.minimum(idx.reshape(-1),
                                    torch.maximum(deg - 1, zero))
                val = pv & (seq.reshape(-1) < deg)
            # an invalid slot reads position 0 (a node with no in-edges may
            # start past the last one) and echoes its parent's id: X[nid]
            # stays in range and its (masked) messages read a real row
            if self.csr_send.numel():
                pick = torch.where(val, lo + idx, zero)
                v = torch.where(val, self.csr_send[pick.long()], v)
            nid_layers.append(v)
            evalid.append(val)
            valid_prev = val
        return torch.cat(nid_layers), torch.cat(evalid)
