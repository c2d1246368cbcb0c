"""Host-side helpers that ``rand_graph`` needs (numpy only).

Copies of ``graphneuralnetworks_tpu/utils.py:normalize_graphdata`` and
``edge_decoding``, so that a seed gives the same edges in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_graphdata", "edge_decoding"]


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


def edge_decoding(idx, n: int, *, directed: bool = True,
                  self_loops: bool = True):
    """Edge ids -> ``(senders, receivers)``: the inverse of the reference's
    ``edge_encoding`` (GNNGraphs utils.jl:240-268)."""
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
