"""Piecewise structured gathers: the API of the JAX package's ``ops/runs.py``.

``run_gather(src, build_run_meta(p, ...))`` is ``src[p]`` with 0 where ``p``
is the dummy index. The JAX package plans such a gather as runs of
consecutive (``run`` mode) or repeated (``const`` mode) source rows per
fixed ``ch``-wide chunk, a descriptor layout that beats the TPU's row-gather
engine; the plan is ``None`` when a chunk needs more than ``k_cap`` pieces
(the caller gathers plainly then). Here the plan keeps that decision and
the piece count, and :func:`run_gather` is one plain index (``index_select``)
on the tensor's device: the descriptor layout was TPU engineering.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RunMeta", "build_run_meta", "run_gather"]


@dataclasses.dataclass(frozen=True)
class RunMeta:
    """A gather plan: ``index`` (``int64[out_len]``) is ``p + 1``, or 0
    where ``p`` is the dummy index (row 0 of the source with a zero row in
    front); :func:`run_gather` reads only ``index``. ``k`` (the most pieces
    a ``ch``-wide chunk needs in this mode), ``ch``, ``const`` and
    ``out_len`` describe the plan as the JAX package's ``RunMeta`` does and
    are kept so that a caller can read them as there."""

    index: torch.Tensor
    k: int
    ch: int = 128
    const: bool = False
    out_len: int = 0


def build_run_meta(p, *, ch: int, dummy_idx=None, const: bool = False,
                   k_cap: int = 32, device=None) -> RunMeta | None:
    """Host-side plan for ``out[i] = src[p[i]]`` (0 where ``p ==
    dummy_idx``), on ``device`` (``None``: the CUDA card).

    Returns None when some ``ch``-wide chunk needs more than ``k_cap``
    pieces: runs of consecutive source ids in ``run`` mode, of one repeated
    id in ``const`` mode (a dummy is a piece of its own), counted as the
    JAX package counts them.
    """
    from .. import resolve_device

    p = np.asarray(p, np.int64).reshape(-1)
    m = p.shape[0]
    if m == 0:
        return None
    m_pad = -(-m // ch) * ch
    q = p
    if m_pad != m:
        pad_val = dummy_idx if dummy_idx is not None else p[-1]
        q = np.concatenate([p, np.full(m_pad - m, pad_val, np.int64)])
    lanes = np.arange(m_pad, dtype=np.int64) % ch
    f = q + 1 if const else q - lanes + ch
    if dummy_idx is not None:
        f = np.where(q == dummy_idx, 0, f)
    is_break = np.ones(m_pad, bool)
    is_break[1:] = f[1:] != f[:-1]
    is_break[::ch] = True
    k = int(np.bincount(np.flatnonzero(is_break) // ch).max())
    if k > k_cap:
        return None
    index = p + 1
    if dummy_idx is not None:
        index = np.where(p == dummy_idx, 0, index)
    return RunMeta(index=torch.as_tensor(index,
                                         device=resolve_device(device)),
                   k=k, ch=ch, const=const, out_len=m)


def run_gather(src: torch.Tensor, meta: RunMeta) -> torch.Tensor:
    """Apply a :class:`RunMeta` plan: ``out[i] = src[p[i]]`` (0 at
    dummies). ``src``: ``[L]`` or ``[L, D]``; returns ``[out_len]`` /
    ``[out_len, D]``."""
    src_p = torch.cat([src.new_zeros((1,) + tuple(src.shape[1:])), src])
    return src_p.index_select(0, meta.index.to(src.device))
