"""Neighbor sampling: minibatch subgraphs for large-graph training.

Counterpart of ``graphneuralnetworks_tpu/sampling.py`` (reference
GNNGraphs/src/sampling.jl — ``sample_neighbors``, :68-118, and
``induced_subgraph``, :173-203 — and GNNGraphs/src/samplers.jl:28-105,
``NeighborLoader``). The draws are the JAX package's: given the same
``np.random.Generator`` (or loader ``seed``), the port samples the same
edges and batches.

- ``sample_neighbors`` and ``induced_subgraph`` are host numpy functions
  feeding :func:`~.graph.graph`.
- ``NeighborLoader`` expands fixed fanouts layer by layer through the C++
  sampler (:mod:`.native`; the Python route ``_sample_py`` only when a
  caller asks for it by setting ``native.sample_layers`` to None). A batch
  is at true size (no ``n_pad``/``e_pad``: PyTorch needs no fixed shapes).
  Its index arrays go to the card from pinned host memory without waiting,
  and :func:`~.graph.device_graph` builds its groupings there, so the host
  never waits for the card.
- ``Prefetcher`` runs a loader (or any iterable) in producer threads, a
  bounded queue ahead of the consumer. The C++ sampler releases the GIL, so
  sampling overlaps the step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from . import native, resolve_device
from .graph import GraphTuple, device_graph, graph, group_by
from .utils import _host

__all__ = ["sample_neighbors", "induced_subgraph", "NeighborLoader",
           "Prefetcher", "in_csr"]


class Prefetcher:
    """Host-ahead-of-device buffering for any batch iterable.

    Daemon producer threads drain the wrapped iterable (e.g. a
    :class:`NeighborLoader`) into a bounded queue so the host samples batch
    k+1..k+size while the device executes batch k. ``host_busy_s``
    accumulates sampling time across all workers —
    ``host_busy_s / (wall * workers)`` is the per-worker sampler utilization
    (near 1.0 means the host sampler is the bottleneck and the device
    starves).

    ``workers > 1`` requires the iterable to expose the work-splitting
    protocol (``epoch_batches()`` + ``sample_batch(seeds, rng)``, as
    :class:`NeighborLoader` does); batches may then be yielded out of order
    (irrelevant for shuffled training).
    """

    def __init__(self, it: Iterable, size: int = 2, *, workers: int = 1):
        self._it = it
        self._size = size
        self._workers = int(workers)
        if self._workers > 1 and not hasattr(it, "epoch_batches"):
            raise ValueError("workers > 1 needs an iterable with the "
                             "epoch_batches/sample_batch protocol")
        self.host_busy_s = 0.0
        self._busy_lock = threading.Lock()

    def __len__(self):
        return len(self._it)

    def __iter__(self):
        if self._workers > 1:
            yield from self._iter_multi()
            return
        q: queue.Queue = queue.Queue(maxsize=self._size)
        done = object()
        # a producer's exception is raised on the consumer side: a dead
        # producer must not look like a short epoch
        failure: list[BaseException] = []

        def produce():
            try:
                it = iter(self._it)
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    self.host_busy_s += time.perf_counter() - t0
                    q.put(item)
            except BaseException as exc:
                failure.append(exc)
            finally:
                q.put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]

    def _iter_multi(self):
        tasks: queue.Queue = queue.Queue()
        batches = self._it.epoch_batches()
        for b in batches:
            tasks.put(b)
        q: queue.Queue = queue.Queue(maxsize=max(self._size, self._workers))
        errors: list[BaseException] = []

        def produce(w):
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=[0x5A17, w]))
            busy = 0.0
            try:
                while True:
                    try:
                        seeds = tasks.get_nowait()
                    except queue.Empty:
                        return
                    t0 = time.perf_counter()
                    try:
                        item = self._it.sample_batch(seeds, rng=rng)
                    except BaseException as exc:  # raised on the consumer
                        errors.append(exc)
                        return
                    busy += time.perf_counter() - t0
                    q.put(item)
            finally:
                with self._busy_lock:     # one += per worker lifetime
                    self.host_busy_s += busy

        threads = [threading.Thread(target=produce, args=(w,), daemon=True)
                   for w in range(self._workers)]
        for t in threads:
            t.start()
        for _ in range(len(batches)):
            while True:
                try:
                    yield q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if errors:
                        raise errors[0]
                    if not any(t.is_alive() for t in threads):
                        return
        for t in threads:
            t.join()
        if errors:
            raise errors[0]


def _csr_by(ids: np.ndarray, nn: int):
    """Group edge indices by node id: returns (order, ptr)."""
    _, order, ptr = group_by(torch.from_numpy(np.ascontiguousarray(ids)), nn)
    return order.numpy(), ptr.long().numpy()


def in_csr(senders: torch.Tensor, receivers: torch.Tensor, num_nodes: int):
    """The in-edge CSR ``(csr_send, csr_eid, ptr)`` that
    :meth:`NeighborLoader.from_csr` and :meth:`DeviceSampler.build
    <.device_sampler.DeviceSampler.build>` take, grouped on the tensors'
    device by :func:`~.graph.group_by`: the senders in receiver order
    (``csr_send``, int32), their edge ids (``csr_eid``, int32) and the row
    offsets (``ptr``, int64). On the card the stable sort of an ogbn-scale
    edge list takes a fraction of a second where the host's takes tens."""
    _, order, ptr = group_by(receivers, num_nodes)
    return senders.int()[order], order.int(), ptr.long()


def sample_neighbors(g: GraphTuple, nodes, K: int = -1, *,
                     dir: str = "in", replace: bool = False,
                     dropnodes: bool = False,
                     rng: np.random.Generator | None = None) -> GraphTuple:
    """Sample up to K incident edges per seed node (sampling.jl:68-118).

    ``dir="in"`` samples edges arriving at the seed nodes (the reference
    default). The result keeps all original node ids (or remapped ids with
    ``dropnodes=True``, the reference's ``NID``), and stores the original
    edge ids in ``edges["EID"]``. It lies on ``g``'s device.
    """
    rng = rng or np.random.default_rng()
    nn = g.num_nodes
    s = _host(g.senders)
    r = _host(g.receivers)
    key = r if dir == "in" else s
    order, ptr = _csr_by(key, nn)

    chosen: list[np.ndarray] = []
    for v in np.asarray(nodes, dtype=np.int64).reshape(-1):
        lo, hi = ptr[v], ptr[v + 1]
        deg = hi - lo
        if deg == 0:
            continue
        k = deg if K < 0 else K
        if replace:
            pick = rng.integers(lo, hi, k)
        else:
            k = min(k, deg)
            pick = lo + rng.permutation(deg)[:k]
        chosen.append(order[pick])
    eid = np.concatenate(chosen) if chosen else np.zeros(0, np.int64)

    s2, r2 = s[eid], r[eid]
    w2 = None if g.edge_weight is None else _host(g.edge_weight)[eid]
    edata = {"EID": eid.astype(np.int32)}
    for kk, v in g.edges.items():
        edata[kk] = _host(v)[eid]

    if dropnodes:
        used = (np.unique(np.concatenate([s2, r2])) if len(s2)
                else np.zeros(0, np.int64))
        remap = -np.ones(nn, np.int64)
        remap[used] = np.arange(len(used))
        nodes_d = {"NID": used.astype(np.int32)}
        for kk, v in g.nodes.items():
            nodes_d[kk] = _host(v)[used]
        return graph(remap[s2], remap[r2], num_nodes=len(used),
                     nodes=nodes_d, edges=edata, edge_weight=w2,
                     device=g.device)
    nodes_d = {kk: _host(v) for kk, v in g.nodes.items()} or None
    return graph(s2, r2, num_nodes=nn, nodes=nodes_d, edges=edata,
                 edge_weight=w2, device=g.device)


def induced_subgraph(g: GraphTuple, nodes) -> GraphTuple:
    """Subgraph on a node subset with remapping (sampling.jl:173-203), on
    ``g``'s device."""
    nn = g.num_nodes
    nodes = np.asarray(nodes, np.int64).reshape(-1)
    mask = np.zeros(nn, bool)
    mask[nodes] = True
    remap = -np.ones(nn, np.int64)
    remap[nodes] = np.arange(len(nodes))
    s = _host(g.senders)
    r = _host(g.receivers)
    keep = mask[s] & mask[r]
    ndata = {k: _host(v)[nodes] for k, v in g.nodes.items()}
    edata = {k: _host(v)[keep] for k, v in g.edges.items()}
    w = g.edge_weight
    return graph(remap[s[keep]], remap[r[keep]], num_nodes=len(nodes),
                 nodes=ndata or None, edges=edata or None,
                 edge_weight=None if w is None else _host(w)[keep],
                 device=g.device)


class NeighborLoader:
    """Layered fixed-fanout minibatch iterator (samplers.jl:28-105).

    Yields GraphTuples on ``device`` whose nodes are [seed batch | sampled
    neighborhood]: ``nodes["NID"]`` holds the original ids (int32), and,
    unless ``minimal_batch``, ``nodes["seed_mask"]`` flags the seed rows,
    ``g``'s node features come gathered, and ``edges["EID"]``, ``g``'s edge
    features and weights ride along. A batch is at true size: no padding.

    ``device``: where batches land; by default ``g``'s device, and the card
    for :meth:`from_csr`.
    """

    def __init__(self, g: GraphTuple, *, num_neighbors: Sequence[int],
                 input_nodes=None, batch_size: int = 32,
                 replace: bool = False, shuffle: bool = True,
                 seed: int = 0, minimal_batch: bool = False, csr=None,
                 device=None):
        self.g = g
        # minimal_batch: ship only the index arrays the train step needs
        # (COO + NID); skip EID/seed_mask/edata/weights. For device-resident
        # feature pipelines where every host->device byte counts.
        self.minimal_batch = minimal_batch
        self.num_neighbors = list(num_neighbors)
        self.batch_size = int(batch_size)
        self.replace = replace
        self.shuffle = shuffle
        self.device = (g.device if device is None and isinstance(g, GraphTuple)
                       else resolve_device(device))
        self._rng = np.random.default_rng(seed)
        nn = int(g.num_nodes)
        self.input_nodes = (np.arange(nn, dtype=np.int64)
                            if input_nodes is None
                            else np.asarray(input_nodes, np.int64))
        if csr is not None:
            # prebuilt in-CSR (see from_csr): skips the argsort pass
            self._csr_send, self._csr_eid, self._ptr = (
                np.ascontiguousarray(csr[0], np.int32),
                np.ascontiguousarray(csr[1], np.int32),
                np.ascontiguousarray(csr[2], np.int64))
        else:
            s = _host(g.senders)
            r = _host(g.receivers)
            order, self._ptr = _csr_by(r, nn)
            # the native sampler's layout: int32 senders and edge ids in
            # CSR position order (two independent loads per sampled edge)
            self._csr_send = s[order].astype(np.int32)
            self._csr_eid = order.astype(np.int32)

    @property
    def csr(self):
        """The loader's in-CSR ``(csr_send, csr_eid, ptr)`` — cache to disk
        and rebuild with :meth:`from_csr` to skip the argsort pass, or feed
        ``(csr_send, ptr)`` to :class:`~.device_sampler.DeviceSampler`."""
        return self._csr_send, self._csr_eid, self._ptr

    @classmethod
    def from_csr(cls, csr_send, csr_eid, ptr, *, num_nodes=None,
                 **kw) -> "NeighborLoader":
        """Build a loader from a prebuilt incoming-edge CSR.

        ``csr_send[ptr[v]:ptr[v+1]]`` are the senders of v's in-edges and
        ``csr_eid`` the matching original edge ids (the layout ``__init__``
        derives with an argsort, which at ogbn scale takes tens of seconds
        on a host). The batches carry no node or edge features.
        """
        from types import SimpleNamespace
        ptr = np.asarray(ptr)
        n = int(num_nodes) if num_nodes is not None else len(ptr) - 1
        shim = SimpleNamespace(num_nodes=n, num_edges=int(len(csr_send)),
                               nodes={}, edges={}, edge_weight=None)
        return cls(shim, csr=(csr_send, csr_eid, ptr), **kw)

    def __len__(self):
        return (len(self.input_nodes) + self.batch_size - 1) \
            // self.batch_size

    def epoch_batches(self) -> list[np.ndarray]:
        """One epoch's seed batches (shuffled; final short batch repeat-
        padded to full size). Part of the Prefetcher multi-worker protocol."""
        seeds_all = self.input_nodes.copy()
        if self.shuffle:
            self._rng.shuffle(seeds_all)
        bs = self.batch_size
        out = []
        for i in range(0, len(seeds_all), bs):
            seeds = seeds_all[i:i + bs]
            if len(seeds) < bs:  # repeat-pad the final short batch
                seeds = np.concatenate(
                    [seeds, seeds_all[: bs - len(seeds)]])
            out.append(seeds)
        return out

    def __iter__(self) -> Iterator[GraphTuple]:
        for seeds in self.epoch_batches():
            yield self._sample_batch(seeds)

    def sample_batch(self, seeds: np.ndarray,
                     rng: np.random.Generator | None = None) -> GraphTuple:
        """Sample one minibatch for explicit seed nodes; thread-safe when
        given a private ``rng`` (the CSR arrays are read-only and the native
        sampler's scratch is thread-local)."""
        return self._sample_batch(seeds, rng=rng)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the loader's device: to the card from pinned
        memory, without waiting."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _sample_batch(self, seeds: np.ndarray,
                      rng: np.random.Generator | None = None) -> GraphTuple:
        rng = rng or self._rng
        if native.sample_layers is None:
            nid, es, er, eid = self._sample_py(seeds, rng)
        else:
            nid, es, er, eid = native.sample_layers(
                self._csr_send, self._csr_eid, self._ptr, seeds,
                self.num_neighbors, self.replace,
                int(rng.integers(0, 2 ** 31 - 1)))
        # nid: original node ids (seeds first, unique); es/er: edges in
        # local ids; eid: original edge ids (the reference's EID)
        nid_t = self._put(nid.astype(np.int32))
        ndata = {"NID": nid_t}
        edata = w2 = None
        if not self.minimal_batch:
            g = self.g
            ndata["seed_mask"] = self._put(np.arange(len(nid)) < len(seeds))
            for k, v in g.nodes.items():
                ndata[k] = v[nid_t.to(v.device).long()].to(self.device)
            # edge data rides along: EID mapping, per-edge features, weights
            # (sampling.jl:72-75 keeps EID; weighted GraphSAGE needs them)
            eid_t = self._put(eid.astype(np.int32))
            edata = {"EID": eid_t}
            for k, v in g.edges.items():
                edata[k] = v[eid_t.to(v.device).long()].to(self.device)
            if g.edge_weight is not None:
                w2 = g.edge_weight[eid_t.to(g.edge_weight.device).long()
                                   ].to(self.device)
        return device_graph(self._put(es), self._put(er),
                            num_nodes=len(nid), nodes=ndata, edges=edata,
                            edge_weight=w2)

    def _sample_py(self, seeds: np.ndarray,
                   rng: np.random.Generator | None = None):
        rng = rng or self._rng
        local = {int(v): i for i, v in enumerate(seeds)}
        nid = list(seeds)
        es, er, eid = [], [], []
        frontier = list(seeds)
        for k in self.num_neighbors:
            nxt = []
            for v in frontier:
                lo, hi = self._ptr[v], self._ptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                if self.replace:
                    pick = rng.integers(lo, hi, k)
                else:
                    kk = min(k, deg)
                    pick = lo + rng.permutation(deg)[:kk]
                for p in pick:
                    e = int(self._csr_eid[p])
                    u = int(self._csr_send[p])
                    if u not in local:
                        local[u] = len(nid)
                        nid.append(u)
                        nxt.append(u)
                    es.append(local[u])
                    er.append(local[int(v)])
                    eid.append(int(e))
            frontier = nxt
        return (np.asarray(nid, np.int64), np.asarray(es, np.int32),
                np.asarray(er, np.int32), np.asarray(eid, np.int64))
