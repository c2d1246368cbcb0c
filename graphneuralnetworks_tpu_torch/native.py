"""The C++ neighbor sampler (``csrc/sampler.cc``), bound via ctypes.

Counterpart of ``graphneuralnetworks_tpu/native``: the same source, built
with ``g++`` into the repository's ``build/`` at first use
(``ops/cuda/build.py:load(..., host=True)``), never into a package directory. The
xorshift RNG lives in the C++, so for one seed the two packages' batches
are the same bits. ctypes releases the GIL for the call, so ``Prefetcher``
threads sample while the step runs.

``NeighborLoader`` takes the Python route (``_sample_py``) only when a
caller sets :data:`sample_layers` to None, as the JAX package's tests do
with theirs; a library that cannot be built raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

__all__ = ["sample_layers", "available"]


@functools.cache
def _lib() -> ctypes.CDLL:
    from .ops.cuda.build import load

    lib = load("sampler", host=True)
    fn = lib.gnn_sample_layers
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.restype = ctypes.c_int64
    fn.argtypes = [i32p, i32p, i64p, i64p, ctypes.c_int64, i64p,
                   ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   i64p, i32p, i32p, i64p, i64p, i64p]
    return lib


def available() -> bool:
    """Whether the library builds and loads (raises nothing)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def sample_layers(csr_send: np.ndarray, csr_eid: np.ndarray,
                  ptr: np.ndarray, seeds: np.ndarray, fanouts,
                  replace: bool, seed: int):
    """C++ layered neighbor expansion (``csrc/sampler.cc``).

    ``csr_send``/``csr_eid`` are the senders and original edge ids of the
    in-edge CSR in position order (int32), ``ptr`` its row offsets. Returns
    ``(nid, es, er, eid)``: the unique node ids reached, seeds first
    (int64); the sampled edges in local ids (int32); their original edge
    ids (int64). Set to None, it sends ``NeighborLoader`` down its Python
    route (module docstring)."""
    lib = _lib()
    csr_send = np.ascontiguousarray(csr_send, np.int32)
    csr_eid = np.ascontiguousarray(csr_eid, np.int32)
    ptr = np.ascontiguousarray(ptr, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    fanouts = np.ascontiguousarray(fanouts, np.int64)
    # the most nodes and edges the seeds can reach: the seeds and
    # prod(fanouts[:l]) new nodes per seed at layer l, one edge each
    cap_nodes, cap_edges, frontier = len(seeds), 0, len(seeds)
    for k in fanouts:
        cap_edges += frontier * int(k)
        frontier *= int(k)
        cap_nodes += frontier
    cap_nodes, cap_edges = max(cap_nodes, 1), max(cap_edges, 1)

    nid = np.empty(cap_nodes, np.int64)
    es = np.empty(cap_edges, np.int32)
    er = np.empty(cap_edges, np.int32)
    eid = np.empty(cap_edges, np.int64)
    n_nodes = np.zeros(1, np.int64)
    n_edges = np.zeros(1, np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.gnn_sample_layers(
        p32(csr_send), p32(csr_eid), p64(ptr), p64(seeds),
        ctypes.c_int64(len(seeds)), p64(fanouts),
        ctypes.c_int64(len(fanouts)), ctypes.c_int32(int(replace)),
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        ctypes.c_int64(len(ptr) - 1),
        ctypes.c_int64(cap_nodes), ctypes.c_int64(cap_edges),
        p64(nid), p32(es), p32(er), p64(eid), p64(n_nodes), p64(n_edges))
    if rc != 0:
        raise RuntimeError(f"native sampler overflow/err rc={rc}")
    nn, ne = int(n_nodes[0]), int(n_edges[0])
    return nid[:nn], es[:ne], er[:ne], eid[:ne]
