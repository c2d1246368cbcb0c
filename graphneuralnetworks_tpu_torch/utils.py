"""Shared utilities: edge-id encodings, feature checks, 1-WL colours.

Counterpart of ``graphneuralnetworks_tpu/utils.py`` (reference GNNGraphs
utils.jl): ``edge_encoding``/``edge_decoding`` (the bijections between
edges and linear ids, utils.jl:189-268), ``color_refinement`` (1-WL,
utils.jl:365-389), ``check_num_nodes``/``check_num_edges`` (utils.jl:1-28)
and ``normalize_graphdata`` (utils.jl:126-183). The encodings are numpy
copies of the JAX package's, so that a seed gives the same edges in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["edge_encoding", "edge_decoding", "color_refinement",
           "check_num_nodes", "check_num_edges", "normalize_graphdata"]


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def normalize_graphdata(data, *, default_name: str = "x", n: int,
                        duplicate_if_needed: bool = False) -> dict:
    """Normalize user-provided feature data into a dict of ``[n, ...]`` arrays.

    ``None`` gives an empty dict and a bare array ``{default_name: array}``;
    with ``n <= 1`` vectors become one-row matrices; with
    ``duplicate_if_needed`` an array of ``n // 2`` rows is repeated once (an
    undirected input whose edge count doubled). Every array must end up with
    ``n`` rows, else ``ValueError``.
    """
    if data is None:
        return {}
    if not isinstance(data, dict):
        data = {default_name: data}
    out = {}
    for k, v in data.items():
        v = np.asarray(v)
        if n <= 1 and (v.ndim == 0 or v.shape[0] != 1):
            v = v[None]
        if duplicate_if_needed and n > 0 and v.ndim and v.shape[0] == n // 2 \
                and v.shape[0] != n:
            v = np.concatenate([v, v], axis=0)
        if n > 1 and (v.ndim == 0 or v.shape[0] != n):
            raise ValueError(
                f"feature {k!r}: wrong size in leading dimension, expected "
                f"{n} but got {v.shape[0] if v.ndim else 'scalar'}")
        out[k] = v
    return out


def check_num_nodes(g, x) -> None:
    """Raise ``ValueError`` unless ``x``'s leading dim is ``g``'s node count
    (utils.jl:1-14; the JAX package checks its padded count)."""
    if x is not None and hasattr(x, "shape") and x.shape[0] != g.num_nodes:
        raise ValueError(f"feature leading dim {x.shape[0]} != node count "
                         f"{g.num_nodes}")


def check_num_edges(g, e) -> None:
    """Raise ``ValueError`` unless ``e``'s leading dim is ``g``'s edge count
    (utils.jl:16-28)."""
    if e is not None and hasattr(e, "shape") and e.shape[0] != g.num_edges:
        raise ValueError(f"feature leading dim {e.shape[0]} != edge count "
                         f"{g.num_edges}")


def edge_encoding(s, r, n: int, *, directed: bool = True,
                  self_loops: bool = True):
    """Bijection ``(s, r) -> `` linear edge id in ``[0, maxid)``
    (utils.jl:189-238), 0-based, for the four cases directed or not, with
    or without self-loops. Returns ``(idx, maxid)``."""
    s = np.asarray(s, dtype=np.int64)
    r = np.asarray(r, dtype=np.int64)
    if directed and self_loops:
        return s * n + r, n * n
    if directed and not self_loops:
        # the rank of (s, r) among the off-diagonal pairs
        return s * (n - 1) + r - (r > s), n * (n - 1)
    lo = np.minimum(s, r)
    hi = np.maximum(s, r)
    if self_loops:
        # pairs (i, j) with i <= j, row-major by i
        return lo * n - lo * (lo - 1) // 2 + (hi - lo), n * (n + 1) // 2
    # pairs (i, j) with i < j
    return (lo * (n - 1) - lo * (lo - 1) // 2 + (hi - lo - 1),
            n * (n - 1) // 2)


def edge_decoding(idx, n: int, *, directed: bool = True,
                  self_loops: bool = True):
    """Edge ids -> ``(senders, receivers)``: the inverse of
    :func:`edge_encoding` (utils.jl:240-268)."""
    idx = np.asarray(idx, dtype=np.int64)
    if directed and self_loops:
        return (idx // n).astype(np.int32), (idx % n).astype(np.int32)
    if directed and not self_loops:
        s = idx // (n - 1)
        rem = idx % (n - 1)
        r = rem + (rem >= s)
        return s.astype(np.int32), r.astype(np.int32)
    if self_loops:
        # invert the triangular (i <= j) ranking
        i = (np.floor((2 * n + 1 - np.sqrt((2 * n + 1) ** 2 - 8.0 * idx)) / 2)
             ).astype(np.int64)
        base = i * n - i * (i - 1) // 2
        while True:  # fix float rounding at row boundaries
            over = base > idx
            if not over.any():
                break
            i = i - over
            base = i * n - i * (i - 1) // 2
        j = i + (idx - base)
        return i.astype(np.int32), j.astype(np.int32)
    # i < j strict
    i = (np.floor((2 * n - 1 - np.sqrt((2 * n - 1) ** 2 - 8.0 * idx)) / 2)
         ).astype(np.int64)
    base = i * (n - 1) - i * (i - 1) // 2
    while True:
        over = base > idx
        if not over.any():
            break
        i = i - over
        base = i * (n - 1) - i * (i - 1) // 2
    j = i + 1 + (idx - base)
    return i.astype(np.int32), j.astype(np.int32)


def color_refinement(g, x0=None, *, max_iters: int = 100):
    """1-Weisfeiler-Leman colour refinement (utils.jl:365-389), on the host.

    A node's new colour numbers its signature (its colour and the sorted
    colours of its in-neighbours) in the order the signatures first appear
    over the nodes, as in the JAX package. Stops when the partition no
    longer changes. Returns ``(colors, num_colors, num_iters)``, ``colors``
    an int32 tensor on ``g``'s device.
    """
    s = g.senders.cpu().numpy()
    r = g.receivers.cpu().numpy()
    nn = g.num_nodes
    colors = (np.zeros(nn, np.int64) if x0 is None else np.array(
        x0.cpu() if isinstance(x0, torch.Tensor) else x0, np.int64))
    niters = 0
    for _ in range(max_iters):
        buckets: list[list[int]] = [[] for _ in range(nn)]
        for a, b in zip(s.tolist(), r.tolist()):
            buckets[b].append(int(colors[a]))
        mapping: dict = {}
        new_colors = np.empty(nn, np.int64)
        for i in range(nn):
            sig = (int(colors[i]), tuple(sorted(buckets[i])))
            new_colors[i] = mapping.setdefault(sig, len(mapping))
        niters += 1
        done = _same_partition(colors, new_colors) and \
            len(set(new_colors.tolist())) == len(set(colors.tolist()))
        colors = new_colors
        if done:
            break
    return (torch.from_numpy(colors.astype(np.int32)).to(g.device),
            len(set(colors.tolist())), niters)


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether every class of ``a`` maps into one class of ``b``."""
    m: dict = {}
    for x, y in zip(a.tolist(), b.tolist()):
        if m.setdefault(x, y) != y:
            return False
    return True
