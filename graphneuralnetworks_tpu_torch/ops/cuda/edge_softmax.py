"""Edge softmax with aggregation on the card: K3 to K12.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/edge_softmax.py``. The
TPU kernels stream edge blocks through one-hot matmuls over 128x512
receiver blocks; here each kernel gives one warp to one (row, head) pair of
a CSR grouping (``csrc/edge_softmax.cu``):

- K12 ``edge_softmax``: over the receiver CSR, the softmax of given
  per-edge logits ``[E, H]`` and the sum of node values (``col`` given) or
  edge values (``col=None``), the numerator scaled by a dropout mask.
- K3 ``gat_softmax``: the same with GAT's logits
  ``leaky_relu(pi[r] + pj[s])`` computed in the kernel.
- K4 ``gat_bwd_dpi`` (receiver CSR) and K5 ``gat_bwd_rev`` (sender CSR):
  GAT's backward, recomputing each edge's attention weight from per-node
  scalars.
- K9 ``gatv2_softmax``: GATv2's logits ``<a_h, leaky_relu(q[r] + k[s])>``
  with the values ``k[s]``, one pass over each row's edges.
- K10 ``gatv2_bwd_dq`` (receiver CSR: ``dq`` and ``da``, the latter in two
  launches, per-warp shares then a fixed-order sum) and K11
  ``gatv2_bwd_rev`` (sender CSR: ``dk``): GATv2's backward.
- K6 ``dot_softmax``: dot-product logits ``lrelu(scale <q[r], k[s]>)``
  (the plain dot when ``slope`` is None) with the values ``v[s]``, one pass
  over each row's edges; K7 ``dot_bwd_dq`` (receiver CSR: ``dq``) and K8
  ``dot_bwd_rev`` (sender CSR: ``dk`` and ``dv``): its backward.

The forward kernels return the unnormalised ``(num, m, s)``; the virtual
self-loop folds in afterwards (:func:`finalize_softmax`). Five autograd
functions sit on top: :func:`edge_softmax_aggregate` (edge values, eager
backward), :func:`edge_softmax_aggregate_nodes` (node values; backward K2
once per head), :func:`gat_attention_nodes` (backward K4 and K5),
:func:`gatv2_attention_nodes` (forward K9, backward K10 and K11) and
:func:`dot_attention_nodes` (forward K6, backward K7 and K8).

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``*_plain``); a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches, and nothing else adds to it. leaky_relu's slope at
``raw == 0`` is 1, as ``jax.nn.leaky_relu`` differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from .build import load
from .spmm import _check, _ptr, _raise_on_error, _route, _row_ids, spmm_sddmm

__all__ = ["launches", "finalize_softmax", "edge_softmax", "gat_softmax",
           "gat_bwd_dpi", "gat_bwd_rev", "gatv2_softmax", "gatv2_bwd_dq",
           "gatv2_bwd_rev", "edge_softmax_plain", "gat_softmax_plain",
           "gat_bwd_dpi_plain", "gat_bwd_rev_plain", "gatv2_softmax_plain",
           "gatv2_bwd_dq_plain", "gatv2_bwd_rev_plain", "dot_softmax",
           "dot_bwd_dq", "dot_bwd_rev", "dot_softmax_plain",
           "dot_bwd_dq_plain", "dot_bwd_rev_plain",
           "edge_softmax_aggregate", "edge_softmax_aggregate_nodes",
           "gat_attention_nodes", "gatv2_attention_nodes",
           "dot_attention_nodes"]

launches = {"k3": 0, "k4": 0, "k5": 0, "k6": 0, "k7": 0, "k8": 0, "k9": 0,
            "k10": 0, "k11": 0, "k12": 0}

_NEG_INF = float("-inf")
# The GATv2 and dot kernels hold a row in at most 8 register chunks of 32
# vectors per lane (csrc/edge_softmax.cu): float4 vectors when the widths
# are multiples of 4 and the row operands 16-byte aligned.
_MAX_VECTORS = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("edge_softmax")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr, n_int, n_f32 in (("edge_softmax_f32", 8, 3, 0),
                                    ("gat_softmax_f32", 8, 3, 1),
                                    ("gat_bwd_dpi_f32", 10, 3, 1),
                                    ("gat_bwd_rev_f32", 11, 3, 1),
                                    ("gatv2_softmax_f32", 8, 3, 1),
                                    ("gatv2_bwd_dq_f32", 11, 4, 1),
                                    ("gatv2_da_reduce_f32", 2, 3, 0),
                                    ("gatv2_bwd_rev_f32", 10, 3, 1),
                                    ("dot_softmax_f32", 8, 4, 2),
                                    ("dot_bwd_dq_f32", 10, 4, 2),
                                    ("dot_bwd_rev_f32", 11, 4, 2)):
        f = getattr(lib, fn)
        f.argtypes = [ptr] * n_ptr + [i32] * n_int + [f32] * n_f32 + [ptr]
        f.restype = i32
    lib.gatv2_bwd_dq_blocks_per_sm.argtypes = [i32, i32]
    lib.gatv2_bwd_dq_blocks_per_sm.restype = i32
    lib.gnn_cuda_error_string.argtypes = [i32]
    lib.gnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lrelu(raw: torch.Tensor, slope: float) -> torch.Tensor:
    """leaky_relu with ``jax.nn.leaky_relu``'s gradient: slope 1 at 0."""
    return torch.where(raw >= 0, raw, slope * raw)


def _dlrelu(raw: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(raw >= 0, torch.ones_like(raw),
                       torch.full_like(raw, slope))


def finalize_softmax(num, m, den, self_logits=None, self_values=None,
                     mask_self=None):
    """Fold the virtual self-loop into a forward's ``(num, m, s)`` and
    normalise: ``(out, mx, den)``.

    The kernels' row max ``m`` never saw the self logit, so the sums are
    rescaled by ``exp(m - max(m, self_logits))`` first. ``mx`` is 0 where
    the row max is ``-inf``, and ``den`` at least ``finfo.tiny``: a node
    with no in-edges and no self-loop gets ``out = 0``.
    """
    if self_logits is not None:
        m_tot = torch.maximum(m, self_logits)
        c = torch.exp(m - m_tot).masked_fill(torch.isneginf(m), 0.0)
        ex_self = torch.exp(self_logits - m_tot)
        den = den * c + ex_self
        sv = (self_values if mask_self is None
              else self_values * mask_self[..., None])
        num = num * c[..., None] + ex_self[..., None] * sv
        mx = m_tot
    else:
        mx = m
    mx = mx.masked_fill(torch.isneginf(mx), 0.0)
    den = den.clamp(min=torch.finfo(num.dtype).tiny)
    return num / den[..., None], mx, den


# ---- plain PyTorch versions (the CPU path, and the reference on the card) --

def _softmax_sums(rows, n, lg, mask, v_e):
    """``(num, m, s)`` of ``lg [E, H]`` and edge rows ``v_e [E, H, D]``
    grouped by ``rows``."""
    m = lg.new_full((n, lg.shape[1]), _NEG_INF).scatter_reduce_(
        0, rows[:, None].expand_as(lg), lg, "amax")
    me = m.index_select(0, rows)
    p = torch.exp(lg - me).masked_fill(torch.isneginf(me), 0.0)
    s = lg.new_zeros(m.shape).index_add_(0, rows, p)
    pw = p if mask is None else p * mask
    num = v_e.new_zeros((n,) + tuple(v_e.shape[1:]))
    return num.index_add_(0, rows, pw[..., None] * v_e), m, s


def edge_softmax_plain(indptr, col, logits, mask, values):
    """K12's function over a receiver CSR: ``(num, m, s)``.

    ``m[i]`` is the max of row ``i``'s logits (``-inf`` for an empty row),
    ``s[i] = sum_e exp(lg_e - m[i])`` and ``num[i] = sum_e exp(lg_e - m[i])
    * mask_e * v_e`` with ``v_e = values[col[e]]`` (node values) or
    ``values[e]`` (``col=None``, edge values); ``mask=None`` is all ones.
    """
    rows = _row_ids(indptr, logits.shape[0])
    v_e = values if col is None else values.index_select(0, col.long())
    return _softmax_sums(rows, indptr.numel() - 1, logits, mask, v_e)


def gat_softmax_plain(indptr, col, pi, pj, values_n, slope):
    """K3's function: :func:`edge_softmax_plain` of the node values with
    logits ``leaky_relu(pi[r_e] + pj[s_e])``."""
    rows, cols = _row_ids(indptr, col.numel()), col.long()
    lg = lrelu(pi.index_select(0, rows) + pj.index_select(0, cols), slope)
    return _softmax_sums(rows, indptr.numel() - 1, lg, None,
                         values_n.index_select(0, cols))


def _gat_edge_terms(r, s, pi, pj, values_n, mx, den, s_n, dy, slope):
    """Per edge: ``alpha``, ``dy[r]`` and ``dlg = alpha * (<v[s], dy[r]> -
    s_n[r]) * leaky_relu'(raw)``."""
    raw = pi.index_select(0, r) + pj.index_select(0, s)
    alpha = (torch.exp(lrelu(raw, slope) - mx.index_select(0, r))
             / den.index_select(0, r))
    dy_e = dy.index_select(0, r)
    vd = (values_n.index_select(0, s) * dy_e).sum(-1)
    dlg = alpha * (vd - s_n.index_select(0, r)) * _dlrelu(raw, slope)
    return alpha, dy_e, dlg


def gat_bwd_dpi_plain(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                      slope):
    """K4's function over the receiver CSR: ``dpi[r] = sum_e dlg_e``."""
    rows = _row_ids(indptr, col.numel())
    _, _, dlg = _gat_edge_terms(rows, col.long(), pi, pj, values_n, mx, den,
                                s_n, dy, slope)
    return pi.new_zeros(pi.shape).index_add_(0, rows, dlg)


def gat_bwd_rev_plain(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                      slope):
    """K5's function over the sender CSR (``col``: the receivers):
    ``(dpj, dv)`` with ``dpj[s] = sum_e dlg_e``, ``dv[s] = sum_e alpha_e
    dy[r_e]``."""
    rows = _row_ids(indptr, col.numel())
    alpha, dy_e, dlg = _gat_edge_terms(col.long(), rows, pi, pj, values_n,
                                       mx, den, s_n, dy, slope)
    dpj = pj.new_zeros(pj.shape).index_add_(0, rows, dlg)
    dv = values_n.new_zeros(values_n.shape).index_add_(
        0, rows, alpha[..., None] * dy_e)
    return dpj, dv


def _gatv2_logits(r, s, q, k, a, slope):
    """Per edge: ``k[s]``, ``raw = q[r] + k[s]``, ``act = leaky_relu(raw)``
    and the logit ``<a[:, h], act>`` (``a`` is ``[O, H]``)."""
    k_e = k.index_select(0, s)
    raw = q.index_select(0, r) + k_e
    act = lrelu(raw, slope)
    return k_e, raw, act, (act * a.t()).sum(-1)


def gatv2_softmax_plain(indptr, col, q, k, a, slope):
    """K9's function over the receiver CSR: :func:`edge_softmax_plain` of
    the values ``k[s_e]`` with logits ``<a_h, leaky_relu(q[r_e] +
    k[s_e])>``."""
    rows = _row_ids(indptr, col.numel())
    k_e, _, _, lg = _gatv2_logits(rows, col.long(), q, k, a, slope)
    return _softmax_sums(rows, indptr.numel() - 1, lg, None, k_e)


def _gatv2_edge_terms(r, s, q, k, a, mx, den, s_n, dy, slope):
    """Per edge: ``alpha``, ``dy[r]``, ``act``, ``dlg = alpha * (<k[s],
    dy[r]> - s_n[r])`` and ``dlg * a * leaky_relu'(raw)``."""
    k_e, raw, act, lg = _gatv2_logits(r, s, q, k, a, slope)
    alpha = torch.exp(lg - mx.index_select(0, r)) / den.index_select(0, r)
    dy_e = dy.index_select(0, r)
    dlg = alpha * ((k_e * dy_e).sum(-1) - s_n.index_select(0, r))
    draw = dlg[..., None] * a.t() * _dlrelu(raw, slope)
    return alpha, dy_e, act, dlg, draw


def gatv2_bwd_dq_plain(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K10's function over the receiver CSR: ``(dq, da)`` with ``dq[r] =
    sum_e dlg_e a lrelu'(raw_e)`` and ``da [O, H] = sum_e act_e^T dlg_e``
    (edge_softmax.py:1444-1459)."""
    rows = _row_ids(indptr, col.numel())
    _, _, act, dlg, draw = _gatv2_edge_terms(rows, col.long(), q, k, a, mx,
                                             den, s_n, dy, slope)
    dq = q.new_zeros(q.shape).index_add_(0, rows, draw)
    return dq, torch.einsum("ehf,eh->fh", act, dlg)


def gatv2_bwd_rev_plain(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K11's function over the sender CSR (``col``: the receivers):
    ``dk[s] = sum_e dlg_e a lrelu'(raw_e) + alpha_e dy[r_e]``
    (edge_softmax.py:1506-1516)."""
    rows = _row_ids(indptr, col.numel())
    alpha, dy_e, _, _, draw = _gatv2_edge_terms(col.long(), rows, q, k, a,
                                                mx, den, s_n, dy, slope)
    return k.new_zeros(k.shape).index_add_(0, rows,
                                           draw + alpha[..., None] * dy_e)


def _dot_logits(r, s, q, k, scale, slope):
    """Per edge: ``raw = scale * <q[r], k[s]>`` and the logit, ``raw`` or
    ``leaky_relu(raw, slope)``."""
    raw = scale * (q.index_select(0, r) * k.index_select(0, s)).sum(-1)
    return raw, (raw if slope is None else lrelu(raw, slope))


def dot_softmax_plain(indptr, col, q, k, v, scale, slope):
    """K6's function over the receiver CSR: :func:`edge_softmax_plain` of
    the values ``v[s_e]`` with logits ``scale * <q[r_e], k[s_e]>``, through
    ``leaky_relu(., slope)`` unless ``slope`` is None
    (edge_softmax.py:295-339)."""
    rows, cols = _row_ids(indptr, col.numel()), col.long()
    _, lg = _dot_logits(rows, cols, q, k, scale, slope)
    return _softmax_sums(rows, indptr.numel() - 1, lg, None,
                         v.index_select(0, cols))


def _dot_edge_terms(r, s, q, k, v, mx, den, s_n, dy, scale, slope):
    """Per edge: ``alpha``, ``dy[r]`` and ``dlg = alpha * (<v[s], dy[r]> -
    s_n[r]) * dsig`` with ``dsig = scale * leaky_relu'(raw)``."""
    raw, lg = _dot_logits(r, s, q, k, scale, slope)
    alpha = torch.exp(lg - mx.index_select(0, r)) / den.index_select(0, r)
    dy_e = dy.index_select(0, r)
    dsig = scale if slope is None else scale * _dlrelu(raw, slope)
    vd = (v.index_select(0, s) * dy_e).sum(-1)
    return alpha, dy_e, alpha * (vd - s_n.index_select(0, r)) * dsig


def dot_bwd_dq_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    """K7's function over the receiver CSR: ``dq[r] = sum_e dlg_e k[s_e]``
    (edge_softmax.py:546-596)."""
    rows, cols = _row_ids(indptr, col.numel()), col.long()
    _, _, dlg = _dot_edge_terms(rows, cols, q, k, v, mx, den, s_n, dy, scale,
                                slope)
    return q.new_zeros(q.shape).index_add_(
        0, rows, dlg[..., None] * k.index_select(0, cols))


def dot_bwd_rev_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    """K8's function over the sender CSR (``col``: the receivers): ``(dk,
    dv)`` with ``dk[s] = sum_e dlg_e q[r_e]`` and ``dv[s] = sum_e alpha_e
    dy[r_e]`` (edge_softmax.py:599-650)."""
    rows, recv = _row_ids(indptr, col.numel()), col.long()
    alpha, dy_e, dlg = _dot_edge_terms(recv, rows, q, k, v, mx, den, s_n, dy,
                                       scale, slope)
    dk = k.new_zeros(k.shape).index_add_(
        0, rows, dlg[..., None] * q.index_select(0, recv))
    dv = v.new_zeros(v.shape).index_add_(0, rows, alpha[..., None] * dy_e)
    return dk, dv


# ---- kernel wrappers -------------------------------------------------------

def _check_launch(indptr, col, scalars, rows3, values3=None) -> torch.device:
    """float32 ``[rows, H]`` scalars and ``[rows, H, D]`` rows, int32 CSR,
    all contiguous on one card, with one H and one D. ``values3``: rows
    of a width of their own (dot attention's values beside ``q`` and
    ``k``), one width among them."""
    device = indptr.device
    _check(indptr, "indptr", torch.int32, device)
    _check(col, "col", torch.int32, device)
    values3 = values3 or {}
    for ndim, group in ((2, scalars), (3, rows3), (3, values3)):
        for name, t in group.items():
            _check(t, name, torch.float32, device)
            if t is not None and t.dim() != ndim:
                raise ValueError(f"{name} must have {ndim} dimensions "
                                 f"([rows, H{', D' * (ndim == 3)}]), got "
                                 f"{tuple(t.shape)}")
    heads = {t.shape[1] for group in (scalars, rows3, values3)
             for t in group.values() if t is not None}
    widths = [{t.shape[2] for t in group.values()}
              for group in (rows3, values3) if group]
    if len(heads) != 1 or any(len(w) != 1 for w in widths):
        raise ValueError(f"operands disagree on H or D: heads {heads}, "
                         f"widths {widths}")
    return device


def _same_rows(n: int, **ts) -> None:
    bad = {k: t.shape[0] for k, t in ts.items()
           if t is not None and t.shape[0] != n}
    if bad:
        raise ValueError(f"expected {n} rows, got {bad}")


def _launch(fn: str, key: str, device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(*args, stream)
    launches[key] += 1
    _raise_on_error(lib, code, fn)


def _forward_outputs(n, heads, d, device):
    return (torch.empty((n, heads, d), dtype=torch.float32, device=device),
            torch.empty((n, heads), dtype=torch.float32, device=device),
            torch.empty((n, heads), dtype=torch.float32, device=device))


def _edge_softmax_kernel(indptr, col, logits, mask, values):
    device = _check_launch(indptr, col, {"logits": logits, "mask": mask},
                           {"values": values})
    n, (_, heads, d) = indptr.numel() - 1, values.shape
    _same_rows(col.numel() if col is not None else values.shape[0],
               logits=logits, mask=mask)
    num, m, s = _forward_outputs(n, heads, d, device)
    if n == 0 or heads == 0:
        return num, m, s
    _launch("edge_softmax_f32", "k12", device, _ptr(indptr), _ptr(col),
            _ptr(logits), _ptr(mask), _ptr(values), _ptr(num), _ptr(m),
            _ptr(s), n, heads, d)
    return num, m, s


def _gat_softmax_kernel(indptr, col, pi, pj, values_n, slope):
    device = _check_launch(indptr, col, {"pi": pi, "pj": pj},
                           {"values_n": values_n})
    n, (_, heads, d) = indptr.numel() - 1, values_n.shape
    _same_rows(n, pi=pi)
    _same_rows(values_n.shape[0], pj=pj)
    num, m, s = _forward_outputs(n, heads, d, device)
    if n == 0 or heads == 0:
        return num, m, s
    _launch("gat_softmax_f32", "k3", device, _ptr(indptr), _ptr(col),
            _ptr(pi), _ptr(pj), _ptr(values_n), _ptr(num), _ptr(m), _ptr(s),
            n, heads, d, float(slope))
    return num, m, s


def _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den, s_n, dy):
    device = _check_launch(indptr, col, {"pi": pi, "pj": pj, "mx": mx,
                                         "den": den, "s_n": s_n},
                           {"values_n": values_n, "dy": dy})
    # receiver side and sender side
    _same_rows(pi.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)
    _same_rows(pj.shape[0], values_n=values_n)
    return device, tuple(_ptr(t) for t in (indptr, col, pi, pj, values_n,
                                           mx, den, s_n, dy))


def _gat_bwd_dpi_kernel(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                        slope):
    device, args = _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den,
                                 s_n, dy)
    n, heads, d = indptr.numel() - 1, pi.shape[1], dy.shape[2]
    _same_rows(n, pi=pi)
    dpi = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0 or heads == 0:
        return dpi
    _launch("gat_bwd_dpi_f32", "k4", device, *args, _ptr(dpi), n, heads, d,
            float(slope))
    return dpi


def _gat_bwd_rev_kernel(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                        slope):
    device, args = _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den,
                                 s_n, dy)
    n, heads, d = indptr.numel() - 1, pi.shape[1], dy.shape[2]
    _same_rows(n, pj=pj)
    dpj = torch.empty((n, heads), dtype=torch.float32, device=device)
    dv = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    if n == 0 or heads == 0:
        return dpj, dv
    _launch("gat_bwd_rev_f32", "k5", device, *args, _ptr(dpj), _ptr(dv), n,
            heads, d, float(slope))
    return dpj, dv


def _float4_rows(d: int, *rows) -> bool:
    """Whether the kernels load rows of ``d`` floats as float4 (the rule of
    csrc/edge_softmax.cu: O % 4 == 0 and every row operand 16-byte
    aligned)."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows)


def _check_width(kernels: str, widths: str, d: int, vec: bool) -> None:
    """The GATv2 and dot kernels take a head's row in at most 256 vectors:
    1024 floats with float4 loads, else 256."""
    if (d // 4 if vec else d) > _MAX_VECTORS:
        raise ValueError(
            f"the {kernels} kernels take rows of at most {4 * _MAX_VECTORS} "
            f"floats per head ({_MAX_VECTORS} when {widths} % 4 != 0 or a "
            f"row operand is not 16-byte aligned), got {d}")


def _check_gatv2_width(d: int, *rows) -> None:
    _check_width("GATv2", "O", d, _float4_rows(d, *rows))


def _gatv2_args(indptr, col, q, k, a, scalars, rows3) -> torch.device:
    """Checks shared by K9-K11: float32 contiguous ``[rows, H, O]`` rows and
    ``[rows, H]`` scalars on one card, ``a [O, H]``, a width they take."""
    device = _check_launch(indptr, col, {"a": a, **scalars},
                           {"q": q, "k": k, **rows3})
    if a.shape[0] != q.shape[2]:
        raise ValueError(f"a must be [O, H] = [{q.shape[2]}, {q.shape[1]}], "
                         f"got {tuple(a.shape)}")
    _check_gatv2_width(q.shape[2], q, k, *rows3.values())
    return device


def _gatv2_softmax_kernel(indptr, col, q, k, a, slope):
    device = _gatv2_args(indptr, col, q, k, a, {}, {})
    n, (_, heads, d) = indptr.numel() - 1, q.shape
    _same_rows(n, q=q)
    num, m, s = _forward_outputs(n, heads, d, device)
    if n == 0 or heads == 0:
        return num, m, s
    _launch("gatv2_softmax_f32", "k9", device, _ptr(indptr), _ptr(col),
            _ptr(q), _ptr(k), _ptr(a), _ptr(num), _ptr(m), _ptr(s), n,
            heads, d, float(slope))
    return num, m, s


def _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n, dy):
    device = _gatv2_args(indptr, col, q, k, a,
                         {"mx": mx, "den": den, "s_n": s_n}, {"dy": dy})
    _same_rows(q.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)   # receivers
    return device, tuple(_ptr(t) for t in (indptr, col, q, k, a, mx, den,
                                           s_n, dy))


_WARPS_PER_BLOCK = 8     # kWarpsPerBlock of csrc/edge_softmax.cu


@functools.cache
def _dq_resident_blocks(index: int, d: int, vec: bool) -> int:
    """How many blocks of K10 (for rows of ``d`` floats) the card ``index``
    holds at once: the CUDA occupancy of its instantiation times the SMs."""
    with torch.cuda.device(index):
        per_sm = _lib().gatv2_bwd_dq_blocks_per_sm(d, int(vec))
    if per_sm <= 0:
        raise RuntimeError(f"no occupancy for gatv2_bwd_dq at O={d}")
    return per_sm * torch.cuda.get_device_properties(
        index).multi_processor_count


def _dq_blocks(tasks: int, heads: int, resident: int) -> int:
    """K10's grid: blocks of 8 warps, one wave of the ``resident`` blocks
    the card holds at once, or fewer when the ``tasks`` (row, head) pairs
    need fewer warps, rounded up so that the warp count is a multiple of H:
    each warp then keeps one head's share of ``da``."""
    unit = heads // math.gcd(_WARPS_PER_BLOCK, heads)
    want = min(-(-tasks // _WARPS_PER_BLOCK), resident)
    return max(unit, -(-want // unit) * unit)


def _gatv2_bwd_dq_kernel(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    device, args = _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n, dy)
    n, heads, d = indptr.numel() - 1, q.shape[1], q.shape[2]
    _same_rows(n, q=q)
    dq = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    da = torch.empty((d, heads), dtype=torch.float32, device=device)
    if n == 0 or heads == 0 or d == 0:
        return dq, da.zero_()
    blocks = _dq_blocks(n * heads, heads, _dq_resident_blocks(
        device.index, d, _float4_rows(d, q, k, dy)))
    warps = _WARPS_PER_BLOCK * blocks
    part = torch.empty((warps, d), dtype=torch.float32, device=device)
    _launch("gatv2_bwd_dq_f32", "k10", device, *args, _ptr(dq), _ptr(part),
            n, heads, d, blocks, float(slope))
    _launch("gatv2_da_reduce_f32", "k10", device, _ptr(part), _ptr(da),
            warps, heads, d)
    return dq, da


def _gatv2_bwd_rev_kernel(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    device, args = _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n, dy)
    n, heads, d = indptr.numel() - 1, k.shape[1], k.shape[2]
    _same_rows(n, k=k)
    dk = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    if n == 0 or heads == 0 or d == 0:
        return dk
    _launch("gatv2_bwd_rev_f32", "k11", device, *args, _ptr(dk), n, heads,
            d, float(slope))
    return dk


def _dot_args(indptr, col, q, k, v, scalars, rows_o, rows_d):
    """Checks shared by K6-K8: float32 contiguous ``[rows, H, O]`` (``q``,
    ``k``, ``rows_o``) and ``[rows, H, D]`` (``v``, ``rows_d``) rows and
    ``[rows, H]`` scalars on one card; ``k`` and ``v`` have the senders'
    rows; a width the kernels take. Returns the device and the pointers
    of ``indptr, col, q, k, v``."""
    device = _check_launch(indptr, col, scalars, {"q": q, "k": k, **rows_o},
                           {"v": v, **rows_d})
    _same_rows(v.shape[0], k=k)
    o, d = q.shape[2], v.shape[2]
    rows = (q, k, v, *rows_o.values(), *rows_d.values())
    _check_width("dot-attention", "O or D", max(o, d),
                 _float4_rows(o, *rows) and d % 4 == 0)
    return device, tuple(_ptr(t) for t in (indptr, col, q, k, v))


def _kernel_slope(slope) -> float:
    """The kernels' slope: None (the plain dot) is slope 1, which is the
    identity bit for bit."""
    return 1.0 if slope is None else float(slope)


def _dot_softmax_kernel(indptr, col, q, k, v, scale, slope):
    device, args = _dot_args(indptr, col, q, k, v, {}, {}, {})
    n, heads, o, d = indptr.numel() - 1, q.shape[1], q.shape[2], v.shape[2]
    _same_rows(n, q=q)
    num, m, s = _forward_outputs(n, heads, d, device)
    if n == 0 or heads == 0:
        return num, m, s
    _launch("dot_softmax_f32", "k6", device, *args, _ptr(num), _ptr(m),
            _ptr(s), n, heads, o, d, float(scale), _kernel_slope(slope))
    return num, m, s


def _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy):
    device, args = _dot_args(indptr, col, q, k, v,
                             {"mx": mx, "den": den, "s_n": s_n}, {},
                             {"dy": dy})
    _same_rows(q.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)   # receivers
    return device, args + tuple(_ptr(t) for t in (mx, den, s_n, dy))


def _dot_bwd_dq_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    device, args = _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy)
    n, heads, o, d = indptr.numel() - 1, q.shape[1], q.shape[2], v.shape[2]
    _same_rows(n, q=q)
    dq = torch.empty((n, heads, o), dtype=torch.float32, device=device)
    if n == 0 or heads == 0:
        return dq
    _launch("dot_bwd_dq_f32", "k7", device, *args, _ptr(dq), n, heads, o, d,
            float(scale), _kernel_slope(slope))
    return dq


def _dot_bwd_rev_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                        slope):
    device, args = _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy)
    n, heads, o, d = indptr.numel() - 1, k.shape[1], k.shape[2], v.shape[2]
    _same_rows(n, k=k)
    dk = torch.empty((n, heads, o), dtype=torch.float32, device=device)
    dv = torch.empty((n, heads, d), dtype=torch.float32, device=device)
    if n == 0 or heads == 0:
        return dk, dv
    _launch("dot_bwd_rev_f32", "k8", device, *args, _ptr(dk), _ptr(dv), n,
            heads, o, d, float(scale), _kernel_slope(slope))
    return dk, dv


def edge_softmax(indptr, col, logits, mask, values):
    """K12 on CUDA tensors, :func:`edge_softmax_plain` on CPU tensors."""
    if _route(values) == "cpu":
        return edge_softmax_plain(indptr, col, logits, mask, values)
    return _edge_softmax_kernel(indptr, col, logits, mask, values)


def gat_softmax(indptr, col, pi, pj, values_n, slope):
    """K3 on CUDA tensors, :func:`gat_softmax_plain` on CPU tensors."""
    if _route(values_n) == "cpu":
        return gat_softmax_plain(indptr, col, pi, pj, values_n, slope)
    return _gat_softmax_kernel(indptr, col, pi, pj, values_n, slope)


def gat_bwd_dpi(indptr, col, pi, pj, values_n, mx, den, s_n, dy, slope):
    """K4 on CUDA tensors, :func:`gat_bwd_dpi_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return gat_bwd_dpi_plain(indptr, col, pi, pj, values_n, mx, den, s_n,
                                 dy, slope)
    return _gat_bwd_dpi_kernel(indptr, col, pi, pj, values_n, mx, den, s_n,
                               dy, slope)


def gat_bwd_rev(indptr, col, pi, pj, values_n, mx, den, s_n, dy, slope):
    """K5 on CUDA tensors, :func:`gat_bwd_rev_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return gat_bwd_rev_plain(indptr, col, pi, pj, values_n, mx, den, s_n,
                                 dy, slope)
    return _gat_bwd_rev_kernel(indptr, col, pi, pj, values_n, mx, den, s_n,
                               dy, slope)


def gatv2_softmax(indptr, col, q, k, a, slope):
    """K9 on CUDA tensors, :func:`gatv2_softmax_plain` on CPU tensors."""
    if _route(k) == "cpu":
        return gatv2_softmax_plain(indptr, col, q, k, a, slope)
    return _gatv2_softmax_kernel(indptr, col, q, k, a, slope)


def gatv2_bwd_dq(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K10 on CUDA tensors, :func:`gatv2_bwd_dq_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return gatv2_bwd_dq_plain(indptr, col, q, k, a, mx, den, s_n, dy,
                                  slope)
    return _gatv2_bwd_dq_kernel(indptr, col, q, k, a, mx, den, s_n, dy, slope)


def gatv2_bwd_rev(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K11 on CUDA tensors, :func:`gatv2_bwd_rev_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return gatv2_bwd_rev_plain(indptr, col, q, k, a, mx, den, s_n, dy,
                                   slope)
    return _gatv2_bwd_rev_kernel(indptr, col, q, k, a, mx, den, s_n, dy,
                                 slope)


def dot_softmax(indptr, col, q, k, v, scale, slope):
    """K6 on CUDA tensors, :func:`dot_softmax_plain` on CPU tensors."""
    if _route(v) == "cpu":
        return dot_softmax_plain(indptr, col, q, k, v, scale, slope)
    return _dot_softmax_kernel(indptr, col, q, k, v, scale, slope)


def dot_bwd_dq(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    """K7 on CUDA tensors, :func:`dot_bwd_dq_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return dot_bwd_dq_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                                slope)
    return _dot_bwd_dq_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                              slope)


def dot_bwd_rev(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    """K8 on CUDA tensors, :func:`dot_bwd_rev_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return dot_bwd_rev_plain(indptr, col, q, k, v, mx, den, s_n, dy,
                                 scale, slope)
    return _dot_bwd_rev_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                               slope)


# ---- autograd --------------------------------------------------------------

def _contiguous(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def _self_grads(self_logits, self_values, mask_self, mx, den, s_n, dy):
    """Gradients of the self logit and self value (edge_softmax.py:1216)."""
    if self_logits is None:
        return None, None
    alpha = torch.exp(self_logits - mx) / den
    m_alpha = alpha if mask_self is None else alpha * mask_self
    dsl = m_alpha * (self_values * dy).sum(-1) - alpha * s_n
    return dsl, m_alpha[..., None] * dy


def _edge_alpha(logits, mask_e, mx, den, receivers):
    alpha = (torch.exp(logits - mx.index_select(0, receivers))
             / den.index_select(0, receivers))
    return alpha, (alpha if mask_e is None else alpha * mask_e)


class EdgeSoftmaxFunction(torch.autograd.Function):
    """Softmax over in-edges and sum of EDGE values; K12 forward, eager
    backward (edge_softmax.py:182-212)."""

    @staticmethod
    def forward(ctx, logits, values, self_logits, self_values, mask_e,
                mask_self, indptr_r, receivers):
        logits, values, mask_e = _contiguous(logits, values, mask_e)
        num, m, s = edge_softmax(indptr_r, None, logits, mask_e, values)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values,
                                        mask_self)
        ctx.save_for_backward(logits, values, self_logits, self_values,
                              mask_e, mask_self, out, mx, den, receivers)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (logits, values, self_logits, self_values, mask_e, mask_self, out,
         mx, den, r) = ctx.saved_tensors
        alpha, m_alpha = _edge_alpha(logits, mask_e, mx, den, r)
        dy_e = dy.index_select(0, r)
        s_n = (out * dy).sum(-1)
        dl = (m_alpha * (values * dy_e).sum(-1)
              - alpha * s_n.index_select(0, r))
        dsl, dsv = _self_grads(self_logits, self_values, mask_self, mx, den,
                               s_n, dy)
        return (dl, m_alpha[..., None] * dy_e, dsl, dsv, None, None, None,
                None)


class EdgeSoftmaxNodesFunction(torch.autograd.Function):
    """Softmax over in-edges and sum of the senders' NODE values; K12
    forward. Backward: per head, one K2 sweep over the sender CSR with
    ``w = mask * alpha`` gives both ``dv[:, h]`` and the per-edge
    ``<v[s_e], dy[r_e]>`` of the logit gradient (edge_softmax.py:1756)."""

    @staticmethod
    def forward(ctx, logits, values_n, self_logits, self_values, mask_e,
                mask_self, indptr_r, col_r, indptr_s, col_s, eid_s,
                receivers):
        logits, values_n, mask_e = _contiguous(logits, values_n, mask_e)
        num, m, s = edge_softmax(indptr_r, col_r, logits, mask_e, values_n)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values,
                                        mask_self)
        ctx.save_for_backward(logits, values_n, self_logits, self_values,
                              mask_e, mask_self, out, mx, den, indptr_s,
                              col_s, eid_s, receivers)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (logits, values_n, self_logits, self_values, mask_e, mask_self, out,
         mx, den, indptr_s, col_s, eid_s, r) = ctx.saved_tensors
        alpha, m_alpha = _edge_alpha(logits, mask_e, mx, den, r)
        s_n = (out * dy).sum(-1)
        dv, dots = [], []
        for h in range(logits.shape[1]):
            dx, dw = spmm_sddmm(indptr_s, col_s, eid_s, m_alpha[:, h].contiguous(),
                                dy[:, h].contiguous(),
                                values_n[:, h].contiguous())
            dv.append(dx)
            dots.append(dw)
        dl = (m_alpha * torch.stack(dots, 1)
              - alpha * s_n.index_select(0, r))
        dsl, dsv = _self_grads(self_logits, self_values, mask_self, mx, den,
                               s_n, dy)
        return (dl, torch.stack(dv, 1), dsl, dsv) + (None,) * 8


class GatAttentionFunction(torch.autograd.Function):
    """GAT attention with logits ``leaky_relu(pi[r] + pj[s])`` computed in
    the kernel: K3 forward, K4 (``dpi``) and K5 (``dpj``, ``dv``) backward
    (edge_softmax.py:870-1229)."""

    @staticmethod
    def forward(ctx, pi, pj, values_n, self_logits, self_values, indptr_r,
                col_r, indptr_s, col_s, slope):
        pi, pj, values_n = _contiguous(pi, pj, values_n)
        num, m, s = gat_softmax(indptr_r, col_r, pi, pj, values_n, slope)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values)
        ctx.slope = slope
        ctx.save_for_backward(pi, pj, values_n, self_logits, self_values,
                              out, mx, den, indptr_r, col_r, indptr_s, col_s)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (pi, pj, values_n, self_logits, self_values, out, mx, den, indptr_r,
         col_r, indptr_s, col_s) = ctx.saved_tensors
        dy = dy.contiguous()
        s_n = (out * dy).sum(-1)
        args = (pi, pj, values_n, mx, den, s_n, dy, ctx.slope)
        need = ctx.needs_input_grad
        dpi = gat_bwd_dpi(indptr_r, col_r, *args) if need[0] else None
        dpj = dv = None
        if need[1] or need[2]:
            dpj, dv = gat_bwd_rev(indptr_s, col_s, *args)
        dsl, dsv = _self_grads(self_logits, self_values, None, mx, den, s_n,
                               dy)
        return (dpi, dpj, dv, dsl, dsv) + (None,) * 5


class GatV2AttentionFunction(torch.autograd.Function):
    """GATv2 attention with logits ``<a_h, leaky_relu(q[r] + k[s])>`` and
    values ``k[s]``: K9 forward, K10 (``dq``, ``da``) and K11 (``dk``)
    backward (edge_softmax.py:1305-1647)."""

    @staticmethod
    def forward(ctx, q, k, a, self_logits, self_values, indptr_r, col_r,
                indptr_s, col_s, slope):
        q, k, a = _contiguous(q, k, a)
        num, m, s = gatv2_softmax(indptr_r, col_r, q, k, a, slope)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values)
        ctx.slope = slope
        ctx.save_for_backward(q, k, a, self_logits, self_values, out, mx,
                              den, indptr_r, col_r, indptr_s, col_s)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (q, k, a, self_logits, self_values, out, mx, den, indptr_r, col_r,
         indptr_s, col_s) = ctx.saved_tensors
        dy = dy.contiguous()
        s_n = (out * dy).sum(-1)
        args = (q, k, a, mx, den, s_n, dy, ctx.slope)
        need = ctx.needs_input_grad
        dq = dk = da = None
        if need[0] or need[2]:
            dq, da = gatv2_bwd_dq(indptr_r, col_r, *args)
        if need[1]:
            dk = gatv2_bwd_rev(indptr_s, col_s, *args)
        dsl, dsv = _self_grads(self_logits, self_values, None, mx, den, s_n,
                               dy)
        return (dq, dk, da, dsl, dsv) + (None,) * 5


class DotAttentionFunction(torch.autograd.Function):
    """Dot attention with logits ``lrelu(scale <q[r], k[s]>)`` (the plain
    dot when ``slope`` is None) and values ``v[s]``: K6 forward, K7
    (``dq``) and K8 (``dk``, ``dv``) backward (edge_softmax.py:473-783)."""

    @staticmethod
    def forward(ctx, q, k, values_n, self_logits, self_values, indptr_r,
                col_r, indptr_s, col_s, scale, slope):
        q, k, values_n = _contiguous(q, k, values_n)
        num, m, s = dot_softmax(indptr_r, col_r, q, k, values_n, scale, slope)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values)
        ctx.scale, ctx.slope = scale, slope
        ctx.save_for_backward(q, k, values_n, self_logits, self_values, out,
                              mx, den, indptr_r, col_r, indptr_s, col_s)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (q, k, values_n, self_logits, self_values, out, mx, den, indptr_r,
         col_r, indptr_s, col_s) = ctx.saved_tensors
        dy = dy.contiguous()
        s_n = (out * dy).sum(-1)
        args = (q, k, values_n, mx, den, s_n, dy, ctx.scale, ctx.slope)
        need = ctx.needs_input_grad
        dq = dot_bwd_dq(indptr_r, col_r, *args) if need[0] else None
        dk = dv = None
        if need[1] or need[2]:
            dk, dv = dot_bwd_rev(indptr_s, col_s, *args)
        dsl, dsv = _self_grads(self_logits, self_values, None, mx, den, s_n,
                               dy)
        return (dq, dk, dv, dsl, dsv) + (None,) * 6


# ---- entry points ----------------------------------------------------------

def _rows(g, num_segments):
    """The receiver CSR cut to ``num_segments`` rows.

    Every receiver must be below ``num_segments``: the backward sweeps read
    the per-receiver state of every edge. Edges are receiver-sorted, so
    that holds when the cut CSR still holds every edge (read from the card
    only when the cut drops rows).
    """
    n = g.num_nodes if num_segments is None else int(num_segments)
    return _cut(g, g.indptr_r, n, "receiver", f"num_segments={n}")


def _senders(g, n_src: int):
    """The sender CSR cut to the ``n_src`` rows of the node values; every
    sender must be below it (the forward gathers ``values_n[s_e]``)."""
    return _cut(g, g.indptr_s, n_src, "sender", f"{n_src} sender rows")


def _cut(g, indptr, n, side, what):
    if n > g.num_nodes:
        raise ValueError(f"{what}, but the graph has {g.num_nodes} nodes")
    indptr = indptr[: n + 1]
    if n < g.num_nodes and int(indptr[-1]) != g.num_edges:
        raise ValueError(f"{what}, but some edges have a {side} at or past "
                         f"it")
    return indptr


def edge_softmax_aggregate(g, logits, values, *, num_segments=None,
                           self_logits=None, self_values=None,
                           dropout_masks=None):
    """Softmax of ``logits [E, H]`` over each node's in-edges, and the
    attention-weighted sum of edge values ``[E, H, D]`` -> ``[n, H, D]``.

    ``self_logits [n, H]`` / ``self_values [n, H, D]`` add a virtual
    self-loop; ``dropout_masks = (mask_e [E, H], mask_self [n, H] or
    None)`` scale the attention weights (0 or 1/(1-p)), not the softmax
    denominator.
    """
    mask_e, mask_self = dropout_masks or (None, None)
    return EdgeSoftmaxFunction.apply(logits, values, self_logits,
                                     self_values, mask_e, mask_self,
                                     _rows(g, num_segments), g.receivers)


def edge_softmax_aggregate_nodes(g, logits, values_n, *, num_segments=None,
                                 self_logits=None, self_values=None,
                                 dropout_masks=None):
    """:func:`edge_softmax_aggregate` of the senders' node values
    ``values_n [N_src, H, D]``: edge ``e`` contributes ``values_n[s_e]``."""
    mask_e, mask_self = dropout_masks or (None, None)
    return EdgeSoftmaxNodesFunction.apply(
        logits, values_n, self_logits, self_values, mask_e, mask_self,
        _rows(g, num_segments), g.col_r, _senders(g, values_n.shape[0]),
        g.col_s, g.eid_s, g.receivers)


def gat_attention_nodes(g, pi, pj, values_n, slope, *, self_logits=None,
                        self_values=None, num_segments=None, pj_weight=None):
    """GAT attention: softmax of ``leaky_relu(pi[r_e] + pj[s_e], slope)``
    over each receiver's in-edges, summing ``values_n[s_e]``.

    ``pi [n, H]`` holds the ``n`` receivers (``num_segments``, default
    ``pi``'s rows); ``pj [N_src, H]`` and ``values_n [N_src, H, D]`` are
    the sender side. ``pj_weight`` (the JAX package's hint for regathering
    ``pj``) is accepted and not used.
    """
    del pj_weight
    n = pi.shape[0] if num_segments is None else num_segments
    return GatAttentionFunction.apply(
        pi, pj, values_n, self_logits, self_values, _rows(g, n), g.col_r,
        _senders(g, values_n.shape[0]), g.col_s, float(slope))


def gatv2_attention_nodes(g, q, k, a, slope, *, self_logits=None,
                          self_values=None, num_segments=None):
    """GATv2 attention: softmax of ``<a[:, h], leaky_relu(q[r_e] + k[s_e],
    slope)>`` over each receiver's in-edges, summing ``k[s_e]``.

    ``q [n, H, O]`` holds the ``n`` receivers (``num_segments``, default
    ``q``'s rows), ``k [N_src, H, O]`` the senders (also the values) and
    ``a [O, H]`` the attention weights.
    """
    n = q.shape[0] if num_segments is None else num_segments
    return GatV2AttentionFunction.apply(
        q, k, a, self_logits, self_values, _rows(g, n), g.col_r,
        _senders(g, k.shape[0]), g.col_s, float(slope))


def dot_attention_nodes(g, q, k, values_n, scale, slope=None, *,
                        self_logits=None, self_values=None, num_segments=None):
    """Dot attention: softmax of ``scale * <q[r_e], k[s_e]>`` (through
    ``leaky_relu(., slope)`` unless ``slope`` is None) over each receiver's
    in-edges, summing ``values_n[s_e]``.

    ``q [n, H, O]`` holds the ``n`` receivers (``num_segments``, default
    ``q``'s rows), ``k [N_src, H, O]`` and ``values_n [N_src, H, D]`` the
    senders. ``self_logits [n, H]`` enter the softmax as they are (already
    scaled), with ``self_values [n, H, D]``.
    """
    n = q.shape[0] if num_segments is None else num_segments
    return DotAttentionFunction.apply(
        q, k, values_n, self_logits, self_values, _rows(g, n), g.col_r,
        _senders(g, values_n.shape[0]), g.col_s, float(scale),
        None if slope is None else float(slope))
