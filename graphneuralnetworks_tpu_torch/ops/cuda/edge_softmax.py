"""Edge softmax with aggregation on the card: K3 to K12.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/edge_softmax.py``. The
TPU kernels stream edge blocks through one-hot matmuls over 128x512
receiver blocks; here each kernel walks a CSR grouping in rows: heads one
after the other in the grid, several rows of one head per warp, several
edges in flight (``csrc/edge_softmax.cu``):

- K12 ``edge_softmax``: over the receiver CSR, the softmax of given
  per-edge logits ``[E, H]`` and the sum of node values (``col`` given) or
  edge values (``col=None``), the numerator scaled by a dropout mask, one
  pass over each row's edges (:func:`_edge_softmax_layout`).
- K3 ``gat_softmax``: the same with GAT's logits
  ``leaky_relu(pi[r] + pj[s])`` computed in the kernel
  (:func:`_gat_softmax_layout`).
- K4 ``gat_bwd_dpi`` (receiver CSR: :func:`_gat_bwd_dpi_layout`) and K5
  ``gat_bwd_rev`` (sender CSR: :func:`_gat_bwd_rev_layout`): GAT's
  backward, recomputing each edge's attention weight from per-node
  scalars.
- K9 ``gatv2_softmax``: GATv2's logits ``<a_h, leaky_relu(q[r] + k[s])>``
  with the values ``k[s]`` (:func:`_gatv2_softmax_layout`).
- K10 ``gatv2_bwd_dq`` (receiver CSR: ``dq`` and ``da``, the latter in two
  launches, per-block shares then a fixed-order sum:
  :func:`_gatv2_bwd_dq_layout`) and K11 ``gatv2_bwd_rev`` (sender CSR:
  ``dk``: :func:`_gatv2_bwd_rev_layout`): GATv2's backward.
- K6 ``dot_softmax``: dot-product logits ``lrelu(scale <q[r], k[s]>)``
  (the plain dot when ``slope`` is None) with the values ``v[s]``, and
  each edge's raw logit where asked (K7's residual); K7 ``dot_bwd_dq``
  (receiver CSR: ``dq``, from those raw logits where given) and K8
  ``dot_bwd_rev`` (sender CSR: ``dk`` and ``dv``): its backward. K6 and K7
  build a head wider than one 128-byte line whose table the L2 cannot hold
  in passes over column strips (:func:`_dot_recv_layout`,
  :func:`_dot_bwd_rev_layout`). bfloat16 K6, K7 and K8 have a layout
  table of their own (``_K6_BF16``, ``_K7_BF16``, ``_K8_BF16``; K6 and K7
  one rule for the strips), and K8 a kernel that stages the gathered rows
  in shared memory and reads the receivers' scalars packed
  (:func:`_receiver_stats`).

The forward kernels return the unnormalised ``(num, m, s)``; the virtual
self-loop folds in afterwards (:func:`finalize_softmax`). Five autograd
functions sit on top: :func:`edge_softmax_aggregate` (edge values, eager
backward), :func:`edge_softmax_aggregate_nodes` (node values; backward one
K2 for all heads), :func:`gat_attention_nodes` (backward K4 and K5),
:func:`gatv2_attention_nodes` (forward K9, backward K10 and K11) and
:func:`dot_attention_nodes` (forward K6, backward K7 and K8).

Mixed precision: K3, K4 and K5 also take bfloat16 node values, ``dy``
and ``pi``/``pj``, K9, K10 and K11 bfloat16 ``q``, ``k``, ``dy`` and
``a`` (widened to float32 for the kernels, exactly), K6, K7 and K8
bfloat16 ``q``, ``k``, ``v`` and ``dy``, and K12 bfloat16 logits, mask and
values, with the softmax state (``m``, ``s``; ``mx``, ``den``, ``s_n``)
and K6's raw logits in float32, as the TPU kernels keep them: every dot
and sum is float32 and each bfloat16 output (``num``, ``dpi``, ``dpj``,
``dv``, ``dq``, ``dk``) is rounded once, in its primal's type; K10's
``da`` is float32; :func:`finalize_softmax` returns ``num``'s type. K12's
node-values backward hands K2 the attention weights ``mask * alpha``
rounded to the values' type, as JAX's scatter casts them
(``edge_softmax.py:1756-1790``), and every gradient comes back in its
primal's type. The plain versions compute bfloat16 inputs the same way.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``*_plain``); a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches (``k3_bf16``, ``k12_bf16``, ...: the bfloat16
variants), and
nothing else adds to it. leaky_relu's slope at
``raw == 0`` is 1, as ``jax.nn.leaky_relu`` differentiates it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ...graph import csr_view
from .build import load
from .spmm import (_call_on, _check, _float4_rows, _ptr, _raise_on_error,
                   _entries, _route, _row_ids, _row_vectors,
                   _windowed_rows, _work_dtype, spmm_sddmm)

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
            "k10": 0, "k11": 0, "k12": 0, "k3_bf16": 0, "k4_bf16": 0,
            "k5_bf16": 0, "k6_bf16": 0, "k7_bf16": 0, "k8_bf16": 0,
            "k9_bf16": 0, "k10_bf16": 0, "k11_bf16": 0, "k12_bf16": 0}

_NEG_INF = float("-inf")
# The GATv2 and dot kernels hold a row in at most 8 register chunks of 32
# vectors per lane (csrc/edge_softmax.cu): float4 vectors when the widths
# are multiples of 4 and the row operands 16-byte aligned (GATv2's
# bfloat16 rows: spmm._row_vectors, 8, 4 or 1 values).
_MAX_VECTORS = 256
# K3, K4, K5 and K12 on bfloat16 rows hold one register chunk
# (csrc/edge_softmax.cu with_row_instances): wider rows take passes of 32
# vectors (256 values).
_BF16_MAX_VECTORS = 32

# The dot kernels' layouts (csrc/edge_softmax.cu), from chip_smoke.py
# --sweep, which times every choice (PERF.md §6). Rows (K6, K7, K8): the
# index windows a row's lanes take on average (spmm._windowed_rows), and,
# for rows of one register chunk (32 vectors), the edges a group loads
# before it reduces them and the register cap; uncapped, two edges in
# flight cost more warps than they gain. Wider rows take one edge at a time
# and no cap: two chunks of two edges' rows held to 64 registers spill.
# K6 and K7 in rows of one register chunk take (edges in flight, register
# cap) _DOT_ROWS_LINE for edge groups of a 128-byte line or more and
# _DOT_ROWS_NARROW for narrower ones. Strips (K6, K7): a head wider than
# one line whose slice of the gathered tables exceeds _DOT_STRIP_BYTES (the
# L2 keeps a 16 MB slice, as for K1's strips) goes in passes over strips of
# one line, each with _DOT_STRIP_INSTANCE (gathers in flight, register
# cap).
_K8_WINDOWS_PER_ROW = 2
_K8_UNROLL = 2
_K8_REG_CAP = 64
# K11 takes K8's rows (heads in the grid, rows per warp, edges in flight),
# with its own (edges in flight, register cap) for rows of one register
# chunk from the same sweep; wider rows one edge, uncapped. Edge groups
# narrower than _K11_PACK_BELOW bytes read the receivers' mx, den and s_n
# packed as one float4 each (an eager stack before the launch), one 16-byte
# load an edge in place of three 4-byte ones: at (1, 8) 0.059 against 0.080
# device-ms, the stack included; at (4, 32) the stack costs more than the
# loads save (PERF.md §6).
_K11_UNROLL = 2
_K11_REG_CAP = 64
_K11_PACK_BELOW = 128
# K10 and K5 take K8's rows too, and for rows of one register chunk K6's
# and K7's (edges in flight, register cap), the fastest for them too in
# the same sweep: 4 edges for groups of a line, 2 for narrower ones; wider
# rows one edge, uncapped. K10's rows take _K10_WINDOWS_PER_ROW index
# windows on average (8 rows a warp at (1, 8) beat 4 by 10 %). K5's edge
# groups of at most _K5_PACK_UP_TO bytes read the receivers' pi, mx, den
# and s_n packed as one float4 each (an eager stack before the launch): at
# (4, 32) and (1, 8) the packed layouts won, the stack included (PERF.md
# §6); wider groups were not measured.
_K10_WINDOWS_PER_ROW = 4
_K5_PACK_UP_TO = 128
# K9 and K3, the forward kernels of GATv2 and GAT, take K10's receiver walk
# in K8's rows, with rows per warp from _K9_WINDOWS_PER_ROW and
# _K3_WINDOWS_PER_ROW index windows a row and, for rows of one register
# chunk, (edges in flight, register cap) _K9_ROWS_LINE or _K9_ROWS_NARROW,
# and (edges in flight, register cap, pj ahead) _K3_ROWS_LINE or
# _K3_ROWS_NARROW, for edge groups of a 128-byte line or more and narrower
# ones: the fastest of chip_smoke.py --sweep k3,k9 (PERF.md §6). With pj
# ahead, K3's lane that holds an edge's index loads its pj one window
# ahead; without, every lane of the group loads it beside the value row.
# Wider rows take one edge, uncapped (K3 with pj ahead, unmeasured).
_K9_WINDOWS_PER_ROW = 8
_K9_ROWS_LINE = (4, 64)
_K9_ROWS_NARROW = (2, 0)
_K3_WINDOWS_PER_ROW = 2
_K3_ROWS_LINE = (4, 64, 1)
_K3_ROWS_NARROW = (1, 0, 0)
# K12 and K4 take K3's walk: rows per warp from _K12_WINDOWS_PER_ROW and
# _K4_WINDOWS_PER_ROW index windows a row and, for rows of one register
# chunk, (edges in flight, register cap) _K12_ROWS_LINE or _K12_ROWS_NARROW
# and (edges in flight, register cap, pj ahead) _K4_ROWS_LINE or
# _K4_ROWS_NARROW, for edge groups of a 128-byte line or more and narrower
# ones: the fastest of chip_smoke.py --sweep k12,k4 (PERF.md §6; at (1, 8)
# 8 rows a warp for K12, 4 for K4). Wider rows take one edge, uncapped (K4
# with pj ahead, unmeasured). K12 reads its [E, H] logits and mask in place
# by CSR position, with a stride of H; with edge values it interleaves the
# heads in the grid (the blocks of every head of the same rows run
# together, as the streamed values suit), with node values it does not.
_K12_WINDOWS_PER_ROW = 4
_K12_ROWS_LINE = (4, 64)
_K12_ROWS_NARROW = (2, 64)
_K4_WINDOWS_PER_ROW = 2
_K4_ROWS_LINE = (4, 64, 1)
_K4_ROWS_NARROW = (2, 64, 0)
_DOT_ROWS_LINE = (4, 64)
_DOT_ROWS_NARROW = (2, 64)
_DOT_STRIP_BYTES = 16 * 2**20
_DOT_LINE_BYTES = 128
_DOT_STRIP_INSTANCE = (4, 0)
# bfloat16 K6 and K8 have a table of their own, from chip_smoke.py --sweep
# bf16 (PERF.md §6): for bf16x8 rows whose wider side is at most so many
# bytes, K6's (edges in flight, register cap, index windows a row) and
# K8's (edges in flight or a stage, register cap, stages, index windows a
# row); stages 0 is the register kernel, more the staged one
# (csrc/edge_softmax.cu), which takes bf16x8 rows of any width (past 512
# bytes in register chunks of 32 vectors, one edge, two stages,
# uncapped). Rows of 8-byte vectors or single values, and K6 rows wider
# than its last entry, take the register kernel as float32 picks it (and
# bfloat16 did before). K6 keeps bf16x8 heads of at most
# _DOT_BF16_ROWS_BYTES in rows whatever their table's size (at AGNN's
# (1, 128, 128) rows beat strips on tables of 32, 64 and 128 MiB); other
# heads take float32's strips rule (wider bf16x8 heads: strips won at 48,
# 66 and 96 MiB), in lines of the widest vector at _DOT_STRIP_INSTANCE.
# K7 gathers the same k[s] and v[s] tables as K6 and takes the same rule
# (:func:`_dot_bf16_strips`; and the strips for bf16x8 heads of more than
# 4 register chunks, whose 8-chunk instance spilled), and in rows its own
# table, _K7_BF16, K6's form, from chip_smoke.py --sweep bf16_k7 (PERF.md
# §6): 16-byte rows one edge at 64 registers, wider ones two. A staged K7
# (K8's ring carrying k, v and the raw logit) lost to this register kernel
# at every shape once the kernel held its row's q and dy packed.
_K6_BF16 = ((32, (1, 0, 2)), (512, (4, 64, 2)))
_K7_BF16 = ((32, (1, 64, 2)), (512, (2, 64, 2)))
_K7_BF16_MAX_ROWS = 4 * 32
_K8_BF16 = ((32, (1, 0, 2, 2)), (512, (2, 0, 2, 4)), (4096, (1, 0, 2, 2)))
_DOT_BF16_ROWS_BYTES = 256


@functools.cache
def _lib(sweep: bool = False) -> ctypes.CDLL:
    lib = load("edge_softmax", sweep=sweep)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr, n_int, n_f32 in (("edge_softmax_f32", 8, 7, 0),
                                    ("edge_softmax_bf16", 8, 7, 0),
                                    ("gat_softmax_f32", 8, 7, 1),
                                    ("gat_bwd_dpi_f32", 10, 7, 1),
                                    ("gat_bwd_rev_f32", 12, 6, 1),
                                    ("gat_softmax_bf16", 8, 7, 1),
                                    ("gat_bwd_dpi_bf16", 10, 7, 1),
                                    ("gat_bwd_rev_bf16", 12, 6, 1),
                                    ("gatv2_softmax_f32", 8, 6, 1),
                                    ("gatv2_bwd_dq_f32", 11, 6, 1),
                                    ("gatv2_da_reduce_f32", 2, 3, 0),
                                    ("gatv2_bwd_rev_f32", 11, 6, 1),
                                    ("gatv2_softmax_bf16", 8, 6, 1),
                                    ("gatv2_bwd_dq_bf16", 11, 6, 1),
                                    ("gatv2_bwd_rev_bf16", 11, 6, 1),
                                    ("dot_softmax_f32", 10, 9, 2),
                                    ("dot_bwd_dq_f32", 12, 9, 2),
                                    ("dot_bwd_rev_f32", 11, 7, 2),
                                    ("dot_softmax_bf16", 10, 9, 2),
                                    ("dot_bwd_dq_bf16", 12, 9, 2),
                                    ("dot_bwd_rev_bf16", 12, 8, 2)):
        f = getattr(lib, fn)
        f.argtypes = [ptr] * n_ptr + [i32] * n_int + [f32] * n_f32 + [ptr]
        f.restype = i32
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
    with no in-edges and no self-loop gets ``out = 0``. ``out`` keeps
    ``num``'s type (a bfloat16 ``num`` over a float32 ``den`` is divided in
    float32 and rounded once); ``mx`` and ``den`` keep the state's.
    """
    out_dtype = num.dtype
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
    den = den.clamp(min=torch.finfo(out_dtype).tiny)
    return (num / den[..., None]).to(out_dtype), mx, den


# ---- plain PyTorch versions (the CPU path, and the reference on the card) --

def _filled(indptr, col):
    """``(rows, cols)``: the row id and ``col`` (int64) of each position
    the CSR fills (``spmm._entries``)."""
    n = _entries(indptr)
    return _row_ids(indptr, n), col[:n].long()


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
    bfloat16 inputs as the kernel takes them: ``m``, ``s`` and the sums in
    float32 from the widened values, ``num`` rounded once to bfloat16.
    """
    n = _entries(indptr)
    rows = _row_ids(indptr, n)
    work = _work_dtype(values.dtype)
    v_e = values[:n] if col is None else values.index_select(0,
                                                              col[:n].long())
    num, m, s = _softmax_sums(rows, indptr.numel() - 1, logits[:n].to(work),
                              None if mask is None else mask[:n].to(work),
                              v_e.to(work))
    return num.to(values.dtype), m, s


def gat_softmax_plain(indptr, col, pi, pj, values_n, slope):
    """K3's function: :func:`edge_softmax_plain` of the node values with
    logits ``leaky_relu(pi[r_e] + pj[s_e])``. bfloat16 inputs as the
    kernel takes them: logits, ``m``, ``s`` and the sums in float32, ``num``
    rounded once to bfloat16."""
    rows, cols = _filled(indptr, col)
    work = _work_dtype(values_n.dtype)
    lg = lrelu(pi.index_select(0, rows).to(work)
               + pj.index_select(0, cols).to(work), slope)
    num, m, s = _softmax_sums(rows, indptr.numel() - 1, lg, None,
                              values_n.index_select(0, cols).to(work))
    return num.to(values_n.dtype), m, s


def _gat_edge_terms(r, s, pi, pj, values_n, mx, den, s_n, dy, slope):
    """Per edge: ``alpha``, ``dy[r]`` and ``dlg = alpha * (<v[s], dy[r]> -
    s_n[r]) * leaky_relu'(raw)``, in the work type of ``values_n``
    (float32 for bfloat16 inputs)."""
    work = _work_dtype(values_n.dtype)
    raw = pi.index_select(0, r).to(work) + pj.index_select(0, s).to(work)
    alpha = (torch.exp(lrelu(raw, slope) - mx.index_select(0, r).to(work))
             / den.index_select(0, r).to(work))
    dy_e = dy.index_select(0, r).to(work)
    vd = (values_n.index_select(0, s).to(work) * dy_e).sum(-1)
    dlg = (alpha * (vd - s_n.index_select(0, r).to(work))
           * _dlrelu(raw, slope))
    return alpha, dy_e, dlg


def gat_bwd_dpi_plain(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                      slope):
    """K4's function over the receiver CSR: ``dpi[r] = sum_e dlg_e``, in
    ``pi``'s type (summed in float32 for bfloat16)."""
    rows, cols = _filled(indptr, col)
    _, _, dlg = _gat_edge_terms(rows, cols, pi, pj, values_n, mx, den, s_n,
                                dy, slope)
    return dlg.new_zeros(pi.shape).index_add_(0, rows, dlg).to(pi.dtype)


def gat_bwd_rev_plain(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                      slope):
    """K5's function over the sender CSR (``col``: the receivers):
    ``(dpj, dv)`` with ``dpj[s] = sum_e dlg_e``, ``dv[s] = sum_e alpha_e
    dy[r_e]``, in ``pj``'s and ``values_n``'s types (summed in float32 for
    bfloat16)."""
    rows, cols = _filled(indptr, col)
    alpha, dy_e, dlg = _gat_edge_terms(cols, rows, pi, pj, values_n, mx, den,
                                       s_n, dy, slope)
    dpj = dlg.new_zeros(pj.shape).index_add_(0, rows, dlg)
    dv = dy_e.new_zeros(values_n.shape).index_add_(
        0, rows, alpha[..., None] * dy_e)
    return dpj.to(pj.dtype), dv.to(values_n.dtype)


def _gatv2_logits(r, s, q, k, a, slope):
    """Per edge, in the work type of ``k`` (float32 for bfloat16 inputs,
    widened before any arithmetic): ``k[s]``, ``raw = q[r] + k[s]``,
    ``act = leaky_relu(raw)`` and the logit ``<a[:, h], act>`` (``a`` is
    ``[O, H]``)."""
    work = _work_dtype(k.dtype)
    k_e = k.index_select(0, s).to(work)
    raw = q.index_select(0, r).to(work) + k_e
    act = lrelu(raw, slope)
    return k_e, raw, act, (act * a.t().to(work)).sum(-1)


def gatv2_softmax_plain(indptr, col, q, k, a, slope):
    """K9's function over the receiver CSR: :func:`edge_softmax_plain` of
    the values ``k[s_e]`` with logits ``<a_h, leaky_relu(q[r_e] +
    k[s_e])>``. bfloat16 inputs as the kernel takes them: logits, ``m``,
    ``s`` and the sums in float32, ``num`` rounded once to bfloat16."""
    rows, cols = _filled(indptr, col)
    k_e, _, _, lg = _gatv2_logits(rows, cols, q, k, a, slope)
    num, m, s = _softmax_sums(rows, indptr.numel() - 1, lg, None, k_e)
    return num.to(k.dtype), m, s


def _gatv2_edge_terms(r, s, q, k, a, mx, den, s_n, dy, slope):
    """Per edge, in the work type of ``k``: ``alpha``, ``dy[r]``, ``act``,
    ``dlg = alpha * (<k[s], dy[r]> - s_n[r])`` and ``dlg * a *
    leaky_relu'(raw)``."""
    k_e, raw, act, lg = _gatv2_logits(r, s, q, k, a, slope)
    work = k_e.dtype
    alpha = (torch.exp(lg - mx.index_select(0, r).to(work))
             / den.index_select(0, r).to(work))
    dy_e = dy.index_select(0, r).to(work)
    dlg = alpha * ((k_e * dy_e).sum(-1) - s_n.index_select(0, r).to(work))
    draw = dlg[..., None] * a.t().to(work) * _dlrelu(raw, slope)
    return alpha, dy_e, act, dlg, draw


def gatv2_bwd_dq_plain(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K10's function over the receiver CSR: ``(dq, da)`` with ``dq[r] =
    sum_e dlg_e a lrelu'(raw_e)`` and ``da [O, H] = sum_e act_e^T dlg_e``
    (edge_softmax.py:1444-1459). bfloat16 inputs as the kernels take them:
    summed in float32, ``dq`` rounded once to bfloat16, ``da`` float32."""
    rows, cols = _filled(indptr, col)
    _, _, act, dlg, draw = _gatv2_edge_terms(rows, cols, q, k, a, mx, den,
                                             s_n, dy, slope)
    dq = draw.new_zeros(q.shape).index_add_(0, rows, draw)
    return dq.to(q.dtype), torch.einsum("ehf,eh->fh", act, dlg)


def gatv2_bwd_rev_plain(indptr, col, q, k, a, mx, den, s_n, dy, slope):
    """K11's function over the sender CSR (``col``: the receivers):
    ``dk[s] = sum_e dlg_e a lrelu'(raw_e) + alpha_e dy[r_e]``
    (edge_softmax.py:1506-1516), in ``k``'s type (summed in float32 for
    bfloat16)."""
    rows, cols = _filled(indptr, col)
    alpha, dy_e, _, _, draw = _gatv2_edge_terms(cols, rows, q, k, a, mx, den,
                                                s_n, dy, slope)
    dk = draw.new_zeros(k.shape).index_add_(0, rows,
                                            draw + alpha[..., None] * dy_e)
    return dk.to(k.dtype)


def _dot_logits(r, s, q, k, scale, slope):
    """Per edge, in the work type of ``k`` (float32 for bfloat16 inputs,
    widened before any arithmetic): ``raw = scale * <q[r], k[s]>`` and the
    logit, ``raw`` or ``leaky_relu(raw, slope)``."""
    work = _work_dtype(k.dtype)
    raw = scale * (q.index_select(0, r).to(work)
                   * k.index_select(0, s).to(work)).sum(-1)
    return raw, (raw if slope is None else lrelu(raw, slope))


def dot_softmax_plain(indptr, col, q, k, v, scale, slope, raw_out=None):
    """K6's function over the receiver CSR: :func:`edge_softmax_plain` of
    the values ``v[s_e]`` with logits ``scale * <q[r_e], k[s_e]>``, through
    ``leaky_relu(., slope)`` unless ``slope`` is None
    (edge_softmax.py:295-339). ``raw_out [E, H]``, where given, receives
    each edge's raw logit ``scale * <q[r_e], k[s_e]>``. bfloat16 inputs as
    the kernel takes them: logits, ``m``, ``s`` and the sums in float32,
    ``num`` rounded once to bfloat16."""
    rows, cols = _filled(indptr, col)
    raw, lg = _dot_logits(rows, cols, q, k, scale, slope)
    if raw_out is not None:
        raw_out[:cols.numel()].copy_(raw)
    num, m, s = _softmax_sums(rows, indptr.numel() - 1, lg, None,
                              v.index_select(0, cols).to(lg.dtype))
    return num.to(v.dtype), m, s


def _dot_edge_terms(r, s, q, k, v, mx, den, s_n, dy, scale, slope,
                    raw=None):
    """Per edge, in the work type of ``k`` (float32 for bfloat16 inputs):
    ``alpha``, ``dy[r]`` and ``dlg = alpha * (<v[s], dy[r]> - s_n[r]) *
    dsig`` with ``dsig = scale * leaky_relu'(raw)``; the raw logits
    computed, or ``raw`` (by edge) where given."""
    work = _work_dtype(k.dtype)
    if raw is None:
        raw, lg = _dot_logits(r, s, q, k, scale, slope)
    else:
        raw = raw.to(work)
        lg = raw if slope is None else lrelu(raw, slope)
    alpha = (torch.exp(lg - mx.index_select(0, r).to(work))
             / den.index_select(0, r).to(work))
    dy_e = dy.index_select(0, r).to(work)
    dsig = scale if slope is None else scale * _dlrelu(raw, slope)
    vd = (v.index_select(0, s).to(work) * dy_e).sum(-1)
    return alpha, dy_e, (alpha * (vd - s_n.index_select(0, r).to(work))
                         * dsig)


def dot_bwd_dq_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope,
                     raw=None):
    """K7's function over the receiver CSR: ``dq[r] = sum_e dlg_e k[s_e]``
    (edge_softmax.py:546-596), with the raw logits ``raw [E, H]`` (K6's
    residual) where given; in ``q``'s type (summed in float32 for
    bfloat16)."""
    rows, cols = _filled(indptr, col)
    _, _, dlg = _dot_edge_terms(rows, cols, q, k, v, mx, den, s_n, dy, scale,
                                slope, None if raw is None
                                else raw[:cols.numel()])
    dq = dlg.new_zeros(q.shape).index_add_(
        0, rows, dlg[..., None] * k.index_select(0, cols).to(dlg.dtype))
    return dq.to(q.dtype)


def dot_bwd_rev_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope):
    """K8's function over the sender CSR (``col``: the receivers): ``(dk,
    dv)`` with ``dk[s] = sum_e dlg_e q[r_e]`` and ``dv[s] = sum_e alpha_e
    dy[r_e]`` (edge_softmax.py:599-650), in ``k``'s and ``v``'s types
    (summed in float32 for bfloat16)."""
    rows, recv = _filled(indptr, col)
    alpha, dy_e, dlg = _dot_edge_terms(recv, rows, q, k, v, mx, den, s_n, dy,
                                       scale, slope)
    dk = dlg.new_zeros(k.shape).index_add_(
        0, rows, dlg[..., None] * q.index_select(0, recv).to(dlg.dtype))
    dv = dy_e.new_zeros(v.shape).index_add_(0, rows, alpha[..., None] * dy_e)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---- kernel wrappers -------------------------------------------------------

def _check_launch(indptr, col, scalars, rows3, values3=None,
                  state=None) -> torch.device:
    """``[rows, H]`` scalars and ``[rows, H, D]`` rows of one float type,
    float32 or bfloat16 (a mix raises ``TypeError``); the float32 softmax
    state ``state`` ``[rows, H]``; int32 CSR; all contiguous on one card,
    with one H and one D. ``values3``: rows of a width of their own (dot
    attention's values beside ``q`` and ``k``), one width among them."""
    device = indptr.device
    _check(indptr, "indptr", torch.int32, device)
    _check(col, "col", torch.int32, device)
    values3, state = values3 or {}, state or {}
    first = next(t for group in (rows3, values3, scalars)
                 for t in group.values() if t is not None)
    dtype = (torch.bfloat16 if first.dtype == torch.bfloat16
             else torch.float32)
    for ndim, group, want in ((2, scalars, dtype), (3, rows3, dtype),
                              (3, values3, dtype), (2, state, torch.float32)):
        for name, t in group.items():
            _check(t, name, want, device)
            if t is not None and t.dim() != ndim:
                raise ValueError(f"{name} must have {ndim} dimensions "
                                 f"([rows, H{', D' * (ndim == 3)}]), got "
                                 f"{tuple(t.shape)}")
    heads = {t.shape[1] for group in (scalars, rows3, values3, state)
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


def _launch(fn: str, key: str, device, *args, sweep: bool = False) -> None:
    lib = _lib(sweep)
    code = _call_on(device, getattr(lib, fn), *args)
    launches[key] += 1
    _raise_on_error(lib, code, fn)


def _forward_outputs(n, heads, d, device, dtype=torch.float32):
    """``num [n, H, d]`` in the values' ``dtype``, ``m`` and ``s [n, H]``
    in float32."""
    return (torch.empty((n, heads, d), dtype=dtype, device=device),
            torch.empty((n, heads), dtype=torch.float32, device=device),
            torch.empty((n, heads), dtype=torch.float32, device=device))


def _edge_softmax_layout(dv: int, vec_bytes: int, n_rows: int, entries: int,
                         node_values: bool, max_vectors: int = _MAX_VECTORS
                         ) -> tuple[int, int, int, int]:
    """K12's ``(log_rows, unroll, reg_cap, interleave)`` for a head of
    ``dv`` vectors of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4
    or 2) and ``entries / n_rows`` edges per receiver on average, with node
    values or edge values: :func:`_windowed_rows` of ``G``-lane edge groups
    at ``_K12_WINDOWS_PER_ROW`` (rows wider than ``max_vectors`` go in
    passes of that many, groups of 32 lanes), :func:`_rows_instance` of
    ``_K12_ROWS_LINE`` and ``_K12_ROWS_NARROW``, and the heads interleaved
    in the grid for edge values only."""
    wide = min(max(dv, 1), max_vectors)
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K12_WINDOWS_PER_ROW)
    return ((log_rows,) + _rows_instance(wide, vec_bytes << log_g,
                                         _K12_ROWS_LINE, _K12_ROWS_NARROW)
            + (int(not node_values),))


def _edge_softmax_kernel(indptr, col, logits, mask, values, layout=None):
    """K12 at :func:`_edge_softmax_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap, interleave)``) from the sweep build of
    the library, which holds every (unroll, reg_cap) instance
    (``build.load``). bfloat16 logits, mask and values take
    ``edge_softmax_bf16``, ``num`` in bfloat16."""
    device = _check_launch(indptr, col, {"logits": logits, "mask": mask},
                           {"values": values})
    n, (_, heads, d) = indptr.numel() - 1, values.shape
    n_edges = col.numel() if col is not None else values.shape[0]
    _same_rows(n_edges, logits=logits, mask=mask)
    num, m, s = _forward_outputs(n, heads, d, device, values.dtype)
    if n == 0 or heads == 0:
        return num, m, s
    sweep = layout is not None
    if not sweep:
        layout = _edge_softmax_layout(
            *_row_vectors(d, values.element_size(), values, num), n, n_edges,
            col is not None, _max_vectors(values))
    _launch(*_gat_fn("edge_softmax", "k12", values), device, _ptr(indptr),
            _ptr(col), _ptr(logits), _ptr(mask), _ptr(values), _ptr(num),
            _ptr(m), _ptr(s), n, heads, d, *layout, sweep=sweep)
    return num, m, s


def _gat_softmax_layout(dv: int, vec_bytes: int, n_rows: int, entries: int,
                        max_vectors: int = _MAX_VECTORS
                        ) -> tuple[int, int, int, int]:
    """K3's ``(log_rows, unroll, reg_cap, ahead)`` for a head of ``dv``
    vectors of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2)
    and ``entries / n_rows`` edges per receiver on average:
    :func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K3_WINDOWS_PER_ROW`` (rows wider than ``max_vectors`` go in passes
    of that many, groups of 32 lanes), and :func:`_rows_instance` of
    ``_K3_ROWS_LINE`` and ``_K3_ROWS_NARROW``."""
    wide = min(max(dv, 1), max_vectors)
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K3_WINDOWS_PER_ROW)
    return (log_rows,) + _rows_instance(wide, vec_bytes << log_g,
                                        _K3_ROWS_LINE, _K3_ROWS_NARROW)


def _gat_softmax_kernel(indptr, col, pi, pj, values_n, slope, layout=None):
    """K3 at :func:`_gat_softmax_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap, ahead)``) from the sweep build of the
    library, which holds every (unroll, reg_cap) instance
    (``build.load``)."""
    device = _check_launch(indptr, col, {"pi": pi, "pj": pj},
                           {"values_n": values_n})
    n, (_, heads, d) = indptr.numel() - 1, values_n.shape
    _same_rows(n, pi=pi)
    _same_rows(values_n.shape[0], pj=pj)
    num, m, s = _forward_outputs(n, heads, d, device, values_n.dtype)
    if n == 0 or heads == 0:
        return num, m, s
    sweep = layout is not None
    if not sweep:
        layout = _gat_softmax_layout(
            *_row_vectors(d, values_n.element_size(), values_n, num), n,
            col.numel(), _max_vectors(values_n))
    _launch(*_gat_fn("gat_softmax", "k3", values_n), device, _ptr(indptr),
            _ptr(col), _ptr(pi), _ptr(pj), _ptr(values_n), _ptr(num),
            _ptr(m), _ptr(s), n, heads, d, *layout, float(slope),
            sweep=sweep)
    return num, m, s


def _gat_fn(fn: str, key: str, values: torch.Tensor) -> tuple[str, str]:
    """The library function ``fn`` of a kernel with a bfloat16 variant
    (K3-K12) and its launch counter ``key`` for ``values``' type."""
    if values.dtype == torch.bfloat16:
        return f"{fn}_bf16", f"{key}_bf16"
    return f"{fn}_f32", key


def _max_vectors(values: torch.Tensor) -> int:
    """The widest row, in vectors, the GAT kernels and K12 hold in
    registers for ``values``' type (wider rows take passes)."""
    return (_BF16_MAX_VECTORS if values.dtype == torch.bfloat16
            else _MAX_VECTORS)


def _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den, s_n, dy):
    device = _check_launch(indptr, col, {"pi": pi, "pj": pj},
                           {"values_n": values_n, "dy": dy},
                           state={"mx": mx, "den": den, "s_n": s_n})
    # receiver side and sender side
    _same_rows(pi.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)
    _same_rows(pj.shape[0], values_n=values_n)
    return device, tuple(_ptr(t) for t in (indptr, col, pi, pj, values_n,
                                           mx, den, s_n, dy))


def _gat_bwd_dpi_layout(dv: int, vec_bytes: int, n_rows: int, entries: int,
                        max_vectors: int = _MAX_VECTORS
                        ) -> tuple[int, int, int, int]:
    """K4's ``(log_rows, unroll, reg_cap, ahead)`` for a head of ``dv``
    vectors of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2)
    and ``entries / n_rows`` edges per receiver on average:
    :func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K4_WINDOWS_PER_ROW`` (rows wider than ``max_vectors`` go in passes
    of that many, groups of 32 lanes), and :func:`_rows_instance` of
    ``_K4_ROWS_LINE`` and ``_K4_ROWS_NARROW``."""
    wide = min(max(dv, 1), max_vectors)
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K4_WINDOWS_PER_ROW)
    return (log_rows,) + _rows_instance(wide, vec_bytes << log_g,
                                        _K4_ROWS_LINE, _K4_ROWS_NARROW)


def _gat_bwd_dpi_kernel(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                        slope, layout=None):
    """K4 at :func:`_gat_bwd_dpi_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap, ahead)``) from the sweep build of the
    library, which holds every (unroll, reg_cap) instance
    (``build.load``)."""
    device, args = _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den,
                                 s_n, dy)
    n, heads, d = indptr.numel() - 1, pi.shape[1], dy.shape[2]
    _same_rows(n, pi=pi)
    dpi = torch.empty((n, heads), dtype=pi.dtype, device=device)
    if n == 0 or heads == 0:
        return dpi
    sweep = layout is not None
    if not sweep:
        layout = _gat_bwd_dpi_layout(
            *_row_vectors(d, dy.element_size(), values_n, dy), n,
            col.numel(), _max_vectors(dy))
    _launch(*_gat_fn("gat_bwd_dpi", "k4", dy), device, *args, _ptr(dpi), n,
            heads, d, *layout, float(slope), sweep=sweep)
    return dpi


def _rows_instance(wide: int, group_bytes: int, line=_DOT_ROWS_LINE,
                   narrow=_DOT_ROWS_NARROW) -> tuple[int, ...]:
    """``(edges in flight, register cap)`` of K5, K6, K7 and K10 (and, with
    their own ``line`` and ``narrow``, of K9, K3, K12 and K4) in rows of
    ``wide``
    vectors in edge groups of ``group_bytes``: for rows of one register
    chunk (at most 32 vectors) ``line`` for groups of a 128-byte line or
    more, ``narrow`` for narrower ones; one edge, uncapped, for wider rows
    (with the rest of ``line``)."""
    if wide > 32:
        return (1, 0) + tuple(line[2:])
    return tuple(line if group_bytes >= _DOT_LINE_BYTES else narrow)


def _gat_bwd_rev_layout(dv: int, vec_bytes: int, n_rows: int, entries: int,
                        max_vectors: int = _MAX_VECTORS
                        ) -> tuple[int, int, int, int]:
    """K5's ``(log_rows, unroll, reg_cap, packed)`` for a head of ``dv``
    vectors of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2)
    and ``entries / n_rows`` edges per sender on average: K8's rows per
    warp (:func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K8_WINDOWS_PER_ROW``; rows wider than ``max_vectors`` go in passes
    of that many, groups of 32 lanes), :func:`_rows_instance`, and the
    receivers' scalars packed for groups of at most ``_K5_PACK_UP_TO``
    bytes."""
    wide = min(max(dv, 1), max_vectors)
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K8_WINDOWS_PER_ROW)
    group = vec_bytes << log_g
    return ((log_rows,) + _rows_instance(wide, group)
            + (int(group <= _K5_PACK_UP_TO),))


def _gat_bwd_rev_kernel(indptr, col, pi, pj, values_n, mx, den, s_n, dy,
                        slope, layout=None):
    """K5 at :func:`_gat_bwd_rev_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap, packed)``) from the sweep build of the
    library, which holds every (unroll, reg_cap) instance (``build.load``).
    ``packed`` stacks the receivers' ``(pi, mx, den, s_n)`` into ``[rows,
    H, 4]`` float32 for the kernel to read in one load an edge (a bfloat16
    ``pi`` widened exactly)."""
    device, args = _gat_bwd_args(indptr, col, pi, pj, values_n, mx, den,
                                 s_n, dy)
    n, heads, d = indptr.numel() - 1, pi.shape[1], dy.shape[2]
    _same_rows(n, pj=pj)
    dpj = torch.empty((n, heads), dtype=pj.dtype, device=device)
    dv = torch.empty((n, heads, d), dtype=values_n.dtype, device=device)
    if n == 0 or heads == 0:
        return dpj, dv
    sweep = layout is not None
    if not sweep:
        layout = _gat_bwd_rev_layout(
            *_row_vectors(d, dy.element_size(), values_n, dy, dv), n,
            col.numel(), _max_vectors(dy))
    stats = (torch.stack((pi.float(), mx, den, s_n), -1) if layout[3]
             else None)
    _launch(*_gat_fn("gat_bwd_rev", "k5", dy), device, *args[:8],
            _ptr(stats), args[8], _ptr(dpj), _ptr(dv), n, heads, d,
            *layout[:3], float(slope), sweep=sweep)
    return dpj, dv


def _check_width(kernels: str, widths: str, d: int, vec: bool) -> None:
    """The GATv2 and dot kernels take a head's row in at most 256 vectors:
    1024 floats with float4 loads, else 256."""
    if (d // 4 if vec else d) > _MAX_VECTORS:
        raise ValueError(
            f"the {kernels} kernels take rows of at most {4 * _MAX_VECTORS} "
            f"floats per head ({_MAX_VECTORS} when {widths} % 4 != 0 or a "
            f"row operand is not 16-byte aligned), got {d}")


def _check_gatv2_width(d: int, *rows) -> None:
    """The GATv2 kernels' widths: 256 vectors a head (float32: float4 or
    float; bfloat16: 8, 4 or 1 values, :func:`~.spmm._row_vectors`)."""
    if rows[0].dtype != torch.bfloat16:
        _check_width("GATv2", "O", d, _float4_rows(d, *rows))
    elif _row_vectors(d, 2, *rows)[0] > _MAX_VECTORS:
        raise ValueError(
            f"the GATv2 kernels take bfloat16 rows of at most "
            f"{_MAX_VECTORS} vectors per head (of 8 values when O % 8 == 0 "
            f"and the row operands are 16-byte aligned, 4 when O % 4 == 0 "
            f"and 8-byte aligned, else 1), got {d}")


def _gatv2_args(indptr, col, q, k, a, state, rows3) -> torch.device:
    """Checks shared by K9-K11: contiguous ``[rows, H, O]`` rows ``q``,
    ``k`` and ``rows3`` and ``a [O, H]``, all float32 or all bfloat16 (a
    mix raises ``TypeError``), the float32 softmax ``state`` ``[rows, H]``,
    on one card; a width they take."""
    device = _check_launch(indptr, col, {"a": a}, {"q": q, "k": k, **rows3},
                           state=state)
    if a.shape[0] != q.shape[2]:
        raise ValueError(f"a must be [O, H] = [{q.shape[2]}, {q.shape[1]}], "
                         f"got {tuple(a.shape)}")
    _check_gatv2_width(q.shape[2], q, k, *rows3.values())
    return device


def _gatv2_softmax_layout(ov: int, vec_bytes: int, n_rows: int,
                          entries: int) -> tuple[int, int, int]:
    """K9's ``(log_rows, unroll, reg_cap)`` for a head of ``ov`` vectors of
    ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2) and
    ``entries / n_rows`` edges per receiver on average:
    :func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K9_WINDOWS_PER_ROW``, and :func:`_rows_instance` of
    ``_K9_ROWS_LINE`` and ``_K9_ROWS_NARROW``."""
    log_g = min((max(ov, 1) - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K9_WINDOWS_PER_ROW)
    return (log_rows,) + _rows_instance(ov, vec_bytes << log_g,
                                        _K9_ROWS_LINE, _K9_ROWS_NARROW)


def _gatv2_softmax_kernel(indptr, col, q, k, a, slope, layout=None):
    """K9 at :func:`_gatv2_softmax_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap)``) from the sweep build of the library,
    which holds every (unroll, reg_cap) instance (``build.load``; bfloat16
    rows: only the shipped ones). bfloat16 rows take
    ``gatv2_softmax_bf16``, ``num`` in bfloat16."""
    device = _gatv2_args(indptr, col, q, k, a, {}, {})
    n, (_, heads, d) = indptr.numel() - 1, q.shape
    _same_rows(n, q=q)
    num, m, s = _forward_outputs(n, heads, d, device, k.dtype)
    if n == 0 or heads == 0:
        return num, m, s
    sweep = layout is not None
    if not sweep:
        layout = _gatv2_softmax_layout(
            *_row_vectors(d, k.element_size(), q, k, num), n, col.numel())
    a32 = a.float()
    _launch(*_gat_fn("gatv2_softmax", "k9", k), device, _ptr(indptr),
            _ptr(col), _ptr(q), _ptr(k), _ptr(a32), _ptr(num), _ptr(m),
            _ptr(s), n, heads, d, *layout, float(slope), sweep=sweep)
    return num, m, s


def _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n, dy):
    """The checks of K10 and K11 and their operands' pointers, ``a``
    widened to float32 (exact for bfloat16), which the returned tuple
    keeps alive past the launch."""
    device = _gatv2_args(indptr, col, q, k, a,
                         {"mx": mx, "den": den, "s_n": s_n}, {"dy": dy})
    _same_rows(q.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)   # receivers
    a32 = a.float()
    return device, tuple(_ptr(t) for t in (indptr, col, q, k, a32, mx, den,
                                           s_n, dy)), a32


_WARPS_PER_BLOCK = 8     # kWarpsPerBlock of csrc/edge_softmax.cu


def _gatv2_bwd_dq_layout(ov: int, vec_bytes: int, n_rows: int,
                         entries: int) -> tuple[int, int, int]:
    """K10's ``(log_rows, unroll, reg_cap)`` for a head of ``ov`` vectors
    of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2) and
    ``entries / n_rows`` edges per receiver on average:
    :func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K10_WINDOWS_PER_ROW``, and :func:`_rows_instance`."""
    log_g = min((max(ov, 1) - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K10_WINDOWS_PER_ROW)
    return (log_rows,) + _rows_instance(ov, vec_bytes << log_g)


def _dq_blocks(n_rows: int, log_rows: int) -> int:
    """K10's blocks per head: 8 warps of ``2^log_rows`` rows each over the
    ``n_rows`` receivers. The grid is that by H (one head a block, so every
    warp keeps one head's share of ``da``), and each block writes one
    partial of ``da`` per entry."""
    row_blocks = -(-n_rows >> log_rows)
    return -(-row_blocks // _WARPS_PER_BLOCK)


def _gatv2_bwd_dq_kernel(indptr, col, q, k, a, mx, den, s_n, dy, slope,
                         layout=None):
    """K10 at :func:`_gatv2_bwd_dq_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap)``) from the sweep build of the library,
    which holds every (unroll, reg_cap) instance (``build.load``; bfloat16
    rows: only the shipped ones). The dq walk writes each block's share of
    ``da`` to ``[H, O, blocks]`` float32 scratch (:func:`_dq_blocks`),
    which a second launch sums in a fixed order. bfloat16 rows take
    ``gatv2_bwd_dq_bf16``, ``dq`` in bfloat16; ``da`` is float32 either
    way, and both launches count under ``k10_bf16``."""
    device, args, _a32 = _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n,
                                         dy)
    n, heads, d = indptr.numel() - 1, q.shape[1], q.shape[2]
    _same_rows(n, q=q)
    dq = torch.empty((n, heads, d), dtype=q.dtype, device=device)
    da = torch.empty((d, heads), dtype=torch.float32, device=device)
    if n == 0 or heads == 0 or d == 0:
        return dq, da.zero_()
    sweep = layout is not None
    if not sweep:
        layout = _gatv2_bwd_dq_layout(
            *_row_vectors(d, dy.element_size(), q, k, dy, dq), n,
            col.numel())
    blocks = _dq_blocks(n, layout[0])
    part = torch.empty((heads, d, blocks), dtype=torch.float32,
                       device=device)
    fn, key = _gat_fn("gatv2_bwd_dq", "k10", dy)
    _launch(fn, key, device, *args, _ptr(dq), _ptr(part), n, heads, d,
            *layout, float(slope), sweep=sweep)
    _launch("gatv2_da_reduce_f32", key, device, _ptr(part), _ptr(da),
            blocks, heads, d, sweep=sweep)
    return dq, da


def _gatv2_bwd_rev_layout(ov: int, vec_bytes: int, n_rows: int,
                          entries: int) -> tuple[int, int, int, int]:
    """K11's ``(log_rows, unroll, reg_cap, packed)`` for a head of ``ov``
    vectors of ``vec_bytes`` (:func:`~.spmm._row_vectors`: 16, 8, 4 or 2)
    and ``entries / n_rows`` edges per sender on average: K8's rows per
    warp (:func:`_windowed_rows` of ``G``-lane edge groups at
    ``_K8_WINDOWS_PER_ROW``); ``_K11_UNROLL`` edges in flight at
    ``_K11_REG_CAP`` registers for rows of one register chunk (at most 32
    vectors), one edge and no cap for wider rows; the receivers' scalars
    packed for groups narrower than ``_K11_PACK_BELOW`` bytes."""
    log_g = min((max(ov, 1) - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K8_WINDOWS_PER_ROW)
    packed = int(vec_bytes << log_g < _K11_PACK_BELOW)
    if ov <= 32:
        return log_rows, _K11_UNROLL, _K11_REG_CAP, packed
    return log_rows, 1, 0, packed


def _receiver_stats(mx, den, s_n):
    """The receivers' ``(mx, den, s_n)`` packed as ``[rows, H, 4]``
    float32 (the fourth ``mx`` again, unread) for one 16-byte load an
    edge."""
    return torch.stack((mx, den, s_n, mx), -1)


def _gatv2_bwd_rev_kernel(indptr, col, q, k, a, mx, den, s_n, dy, slope,
                          layout=None):
    """K11 at :func:`_gatv2_bwd_rev_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap, packed)``) from the sweep build of the
    library, which holds every (unroll, reg_cap) instance (``build.load``;
    bfloat16 rows: only the shipped ones). ``packed`` stacks the
    receivers' float32 ``(mx, den, s_n)`` into ``[rows, H, 4]`` for the
    kernel to read in one load an edge. bfloat16 rows take
    ``gatv2_bwd_rev_bf16``, ``dk`` in bfloat16."""
    device, args, _a32 = _gatv2_bwd_args(indptr, col, q, k, a, mx, den, s_n,
                                         dy)
    n, heads, d = indptr.numel() - 1, k.shape[1], k.shape[2]
    _same_rows(n, k=k)
    dk = torch.empty((n, heads, d), dtype=k.dtype, device=device)
    if n == 0 or heads == 0 or d == 0:
        return dk
    sweep = layout is not None
    if not sweep:
        layout = _gatv2_bwd_rev_layout(
            *_row_vectors(d, dy.element_size(), q, k, dy, dk), n,
            col.numel())
    stats = _receiver_stats(mx, den, s_n) if layout[3] else None
    _launch(*_gat_fn("gatv2_bwd_rev", "k11", dy), device, *args[:8],
            _ptr(stats), args[8], _ptr(dk), n, heads, d, *layout[:3],
            float(slope), sweep=sweep)
    return dk


def _dot_args(indptr, col, q, k, v, state, rows_o, rows_d):
    """Checks shared by K6-K8: contiguous ``[rows, H, O]`` (``q``, ``k``,
    ``rows_o``) and ``[rows, H, D]`` (``v``, ``rows_d``) rows, all float32
    or all bfloat16 (a mix raises ``TypeError``), and the float32 ``state``
    ``[rows, H]`` (the softmax state, ``s_n``, the raw logits), on one
    card; ``k`` and ``v`` have the senders' rows; a width the kernels take
    (:func:`_dot_vectors`). Returns the device and the pointers of
    ``indptr, col, q, k, v``."""
    device = _check_launch(indptr, col, {}, {"q": q, "k": k, **rows_o},
                           {"v": v, **rows_d}, state=state)
    _same_rows(v.shape[0], k=k)
    _dot_vectors(q.shape[2], v.shape[2], q, k, v, *rows_o.values(),
                 *rows_d.values())
    return device, tuple(_ptr(t) for t in (indptr, col, q, k, v))


def _kernel_slope(slope) -> float:
    """The kernels' slope: None (the plain dot) is slope 1, which is the
    identity bit for bit."""
    return 1.0 if slope is None else float(slope)


def _dot_vectors(o: int, d: int, *rows) -> tuple[int, int, int]:
    """``(ov, dv, vec_bytes)``: the vectors of a head's ``o``-wide (q, k)
    and ``d``-wide (v, dy) rows in the one vector both widths and every
    row operand take (:func:`~.spmm._row_vectors` of each, the narrower:
    float32 rows float4 or one float; bfloat16 rows 8, 4 or 1 values), and
    its bytes. The kernels hold a head's wider side in at most 256
    vectors; wider raises ``ValueError``."""
    elem = rows[0].element_size()
    vec = min(_row_vectors(o, elem, *rows)[1],
              _row_vectors(d, elem, *rows)[1])
    per = vec // elem
    if elem == 4:
        _check_width("dot-attention", "O or D", max(o, d), vec == 16)
    elif max(o, d) // per > _MAX_VECTORS:
        raise ValueError(
            f"the dot-attention kernels take bfloat16 rows of at most "
            f"{_MAX_VECTORS} vectors per head (of 8 values when O and D are "
            f"multiples of 8 and the row operands 16-byte aligned, 4 when "
            f"multiples of 4 and 8-byte aligned, else 1), got O = {o}, "
            f"D = {d}")
    return o // per, d // per, vec


def _line_vectors(vec_bytes: int) -> int:
    """The vectors of a strip: one ``_DOT_LINE_BYTES`` line, at most 32 (an
    edge group's lanes: single bfloat16 values take 64-byte strips)."""
    return min(_DOT_LINE_BYTES // vec_bytes, 32)


def _dot_recv_layout(ov: int, dv: int, vec_bytes: int, n_src: int,
                     n_rows: int, entries: int, elem: int = 4,
                     kernel: int = 6) -> tuple[int, ...]:
    """K6's and K7's ``(strips, log_rows, unroll, reg_cap)`` for a head of
    ``ov`` (q, k) and ``dv`` (v, dy) vectors of ``vec_bytes`` (16: float4
    or 8 bfloat16 values; 8: 4 bfloat16 values; 4: a float; 2: one
    bfloat16 value), ``n_src`` sender rows and ``entries / n_rows`` edges
    per receiver on average, rows of ``elem``-byte values.

    Strips (1) for a head wider than one strip (:func:`_line_vectors`)
    whose slice of the wider gathered table exceeds ``_DOT_STRIP_BYTES``:
    :func:`_windowed_rows` rows of one-strip edge groups at
    ``_DOT_STRIP_INSTANCE``. Else rows (0), as many per warp as K8's:
    for rows of one register chunk ``_DOT_ROWS_LINE`` or
    ``_DOT_ROWS_NARROW``, for wider rows one edge in flight, uncapped.
    bfloat16 K6 (``elem`` 2, ``kernel`` 6) takes
    :func:`_dot_softmax_bf16_layout`, bfloat16 K7 (``kernel`` 7)
    :func:`_dot_bwd_dq_bf16_layout`."""
    if elem == 2:
        pick = (_dot_softmax_bf16_layout if kernel == 6
                else _dot_bwd_dq_bf16_layout)
        return pick(ov, dv, vec_bytes, n_src, n_rows, entries)
    wide = max(ov, dv, 1)
    line = _line_vectors(vec_bytes)
    if wide > line and n_src * wide * vec_bytes > _DOT_STRIP_BYTES:
        log_s = (line - 1).bit_length()
        return (1, _windowed_rows(log_s, n_rows, entries,
                                  _K8_WINDOWS_PER_ROW)) + _DOT_STRIP_INSTANCE
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K8_WINDOWS_PER_ROW)
    return (0, log_rows) + _rows_instance(wide, vec_bytes << log_g)


def _bf16_dot_rows(table, ov: int, dv: int, vec_bytes: int, n_rows: int,
                   entries: int) -> tuple[int, ...] | None:
    """The rows of bfloat16 K6 or K8 that ``table`` (``_K6_BF16``,
    ``_K8_BF16``) gives a head of ``ov`` and ``dv`` vectors of the widest
    ``vec_bytes`` its rows take: ``log_rows`` (:func:`_windowed_rows` at
    the entry's windows) and the entry's instance; None for rows of
    narrower vectors than bf16x8 or wider than the table's last entry."""
    row_bytes = max(ov, dv, 1) * vec_bytes
    pick = next((e for most, e in table if row_bytes <= most), None)
    if pick is None or vec_bytes != 16:
        return None
    log_g = min((max(ov, dv, 1) - 1).bit_length(), 5)
    return (_windowed_rows(log_g, n_rows, entries, pick[-1]),) + pick[:-1]


def _dot_bf16_strips(ov: int, dv: int, vec_bytes: int, n_src: int) -> bool:
    """Whether bfloat16 K6 and K7 take the strips for a head of ``ov`` and
    ``dv`` vectors of the widest ``vec_bytes`` its rows take (16, 8 or 2)
    over ``n_src`` sender rows: a head wider than a line whose wider table
    exceeds ``_DOT_STRIP_BYTES``, but for bf16x8 heads of at most
    ``_DOT_BF16_ROWS_BYTES`` (rows at any size)."""
    wide = max(ov, dv, 1)
    return (wide > _line_vectors(vec_bytes)
            and n_src * wide * vec_bytes > _DOT_STRIP_BYTES
            and not (vec_bytes == 16
                     and wide * vec_bytes <= _DOT_BF16_ROWS_BYTES))


def _bf16_recv_layout(table, ov: int, dv: int, vec_bytes: int, n_src: int,
                      n_rows: int, entries: int, strips: bool
                      ) -> tuple[int, int, int, int]:
    """bfloat16 K6's or K7's ``(strips, log_rows, unroll, reg_cap)`` on
    ``table`` (``_K6_BF16``, ``_K7_BF16``): strips at
    ``_DOT_STRIP_INSTANCE``, or rows by the table (:func:`_bf16_dot_rows`),
    or as float32 picks them."""
    wide = max(ov, dv, 1)
    line = _line_vectors(vec_bytes)
    if strips:
        log_s = (line - 1).bit_length()
        return ((1, _windowed_rows(log_s, n_rows, entries,
                                   _K8_WINDOWS_PER_ROW))
                + _DOT_STRIP_INSTANCE)
    rows = _bf16_dot_rows(table, ov, dv, vec_bytes, n_rows, entries)
    if rows is not None:
        return (0,) + rows
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K8_WINDOWS_PER_ROW)
    return (0, log_rows) + _rows_instance(wide, vec_bytes << log_g)


def _dot_softmax_bf16_layout(ov: int, dv: int, vec_bytes: int, n_src: int,
                             n_rows: int, entries: int,
                             strips: bool | None = None
                             ) -> tuple[int, int, int, int]:
    """bfloat16 K6's ``(strips, log_rows, unroll, reg_cap)`` for a head of
    ``ov`` and ``dv`` vectors of the widest ``vec_bytes`` its rows take
    (16, 8 or 2), ``n_src`` sender rows and ``entries / n_rows`` edges per
    receiver: strips by :func:`_dot_bf16_strips` (where ``strips`` is
    None), else rows by ``_K6_BF16`` (:func:`_bf16_dot_rows`), or as
    float32 picks them."""
    if strips is None:
        strips = _dot_bf16_strips(ov, dv, vec_bytes, n_src)
    return _bf16_recv_layout(_K6_BF16, ov, dv, vec_bytes, n_src, n_rows,
                             entries, strips)


def _dot_bwd_dq_bf16_layout(ov: int, dv: int, vec_bytes: int, n_src: int,
                            n_rows: int, entries: int
                            ) -> tuple[int, int, int, int]:
    """bfloat16 K7's ``(strips, log_rows, unroll, reg_cap)``: K6's strips
    rule (:func:`_dot_bf16_strips`), and the strips for bf16x8 heads wider
    than ``_K7_BF16_MAX_ROWS`` vectors; else rows by ``_K7_BF16``, or as
    float32 picks them."""
    strips = (_dot_bf16_strips(ov, dv, vec_bytes, n_src)
              or (vec_bytes == 16 and max(ov, dv) > _K7_BF16_MAX_ROWS))
    return _bf16_recv_layout(_K7_BF16, ov, dv, vec_bytes, n_src, n_rows,
                             entries, strips)


def _strips(vectors: int, vec_bytes: int) -> int:
    """The strips (:func:`_line_vectors`) of a head of ``vectors`` vectors
    of ``vec_bytes``."""
    return -(-vectors // _line_vectors(vec_bytes))


def _recv_layout(layout, ov, dv, vec_bytes, n_src, n_rows, entries,
                 elem=4, kernel=6):
    """``layout``, or :func:`_dot_recv_layout`'s where it is None; and
    whether the call goes to the sweep build."""
    if layout is not None:
        return tuple(layout), True
    return _dot_recv_layout(ov, dv, vec_bytes, n_src, n_rows, entries, elem,
                            kernel), False


def _dot_softmax_kernel(indptr, col, q, k, v, scale, slope, raw_out=None,
                        layout=None):
    """K6 at :func:`_dot_recv_layout`'s layout, or at ``layout``
    (``(strips, log_rows, unroll, reg_cap)``) from the sweep build of the
    library, which holds every instance (``build.load``; bfloat16 rows:
    the shipped ones and, in rows of one register chunk, every (unroll,
    reg_cap) one). Strips allocate their scratch: the partial
    logits of every strip and the weights, ``H * (strips + 1) * E``
    floats, and ``raw_out`` where not given. bfloat16 rows take
    ``dot_softmax_bf16``, ``num`` in bfloat16; ``m``, ``s`` and ``raw_out``
    are float32 either way."""
    device, args = _dot_args(indptr, col, q, k, v, {"raw_out": raw_out}, {},
                             {})
    n, heads, o, d = indptr.numel() - 1, q.shape[1], q.shape[2], v.shape[2]
    n_edges = col.numel()
    _same_rows(n, q=q)
    _same_rows(n_edges, raw_out=raw_out)
    num, m, s = _forward_outputs(n, heads, d, device, v.dtype)
    if n == 0 or heads == 0:
        return num, m, s
    ov, dv, vec = _dot_vectors(o, d, q, k, v, num)
    layout, sweep = _recv_layout(layout, ov, dv, vec, k.shape[0], n, n_edges,
                                 v.element_size())
    scratch = None
    if layout[0]:
        if raw_out is None:
            raw_out = torch.empty((n_edges, heads), dtype=torch.float32,
                                  device=device)
        scratch = torch.empty(heads * (_strips(ov, vec) + 1) * n_edges,
                              dtype=torch.float32, device=device)
    _launch(*_gat_fn("dot_softmax", "k6", v), device, *args, _ptr(num),
            _ptr(m), _ptr(s), _ptr(raw_out), _ptr(scratch), n, heads, o, d,
            n_edges, *layout, float(scale), _kernel_slope(slope),
            sweep=sweep)
    return num, m, s


def _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy, raw=None):
    device, args = _dot_args(indptr, col, q, k, v,
                             {"mx": mx, "den": den, "s_n": s_n, "raw": raw},
                             {}, {"dy": dy})
    _same_rows(q.shape[0], mx=mx, den=den, s_n=s_n, dy=dy)   # receivers
    _same_rows(col.numel(), raw=raw)                         # edges
    return device, args + tuple(_ptr(t) for t in (mx, den, s_n, dy))


def _dot_bwd_dq_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope,
                       raw=None, layout=None):
    """K7 at :func:`_dot_recv_layout`'s layout, or at ``layout`` from the
    sweep build (as :func:`_dot_softmax_kernel`). ``raw [E, H]``: K6's raw
    logits (float32), else recomputed from ``q`` and ``k``. Strips
    allocate their scratch: the weights and the partial ``<v, dy>`` of
    every strip, and without ``raw`` the partial logits. bfloat16 rows take
    ``dot_bwd_dq_bf16``, ``dq`` in bfloat16."""
    device, args = _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy, raw)
    n, heads, o, d = indptr.numel() - 1, q.shape[1], q.shape[2], v.shape[2]
    n_edges = col.numel()
    _same_rows(n, q=q)
    dq = torch.empty((n, heads, o), dtype=q.dtype, device=device)
    if n == 0 or heads == 0:
        return dq
    ov, dv, vec = _dot_vectors(o, d, q, k, v, dy, dq)
    layout, sweep = _recv_layout(layout, ov, dv, vec, k.shape[0], n, n_edges,
                                 dy.element_size(), kernel=7)
    scratch = None
    if layout[0]:
        parts = (1 + _strips(dv, vec)
                 + (_strips(ov, vec) if raw is None else 0))
        scratch = torch.empty(heads * parts * n_edges, dtype=torch.float32,
                              device=device)
    _launch(*_gat_fn("dot_bwd_dq", "k7", dy), device, *args, _ptr(raw),
            _ptr(dq), _ptr(scratch), n, heads, o, d, n_edges, *layout,
            float(scale), _kernel_slope(slope), sweep=sweep)
    return dq


def _dot_bwd_rev_layout(ov: int, dv: int, n_rows: int, entries: int,
                        vec_bytes: int = 16, elem: int = 4
                        ) -> tuple[int, ...]:
    """K8's ``(log_rows, unroll, reg_cap)`` for a head of ``ov`` (q, k) and
    ``dv`` (v, dy) vectors and ``entries / n_rows`` edges per sender on
    average: :func:`_windowed_rows` rows of ``G``-lane edge groups at
    ``_K8_WINDOWS_PER_ROW``; ``_K8_UNROLL`` edges in flight at
    ``_K8_REG_CAP`` registers for rows of one register chunk (at most 32
    vectors), one edge and no cap for wider rows. bfloat16 rows (``elem``
    2, vectors of the widest ``vec_bytes`` they take: 16, 8 or 2) add
    ``stages``: ``_K8_BF16``'s rows (:func:`_bf16_dot_rows`), else the
    above with stages 0."""
    wide = max(ov, dv, 1)
    log_g = min((wide - 1).bit_length(), 5)
    log_rows = _windowed_rows(log_g, n_rows, entries, _K8_WINDOWS_PER_ROW)
    rows = ((log_rows, _K8_UNROLL, _K8_REG_CAP) if wide <= 32
            else (log_rows, 1, 0))
    if elem == 4:
        return rows
    return (_bf16_dot_rows(_K8_BF16, ov, dv, vec_bytes, n_rows, entries)
            or rows + (0,))


def _dot_bwd_rev_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                        slope, layout=None):
    """K8 at :func:`_dot_bwd_rev_layout`'s layout, or at ``layout``
    (``(log_rows, unroll, reg_cap)``; bfloat16 rows also ``stages``) from
    the sweep build of the library, which holds every (unroll, reg_cap)
    instance (``build.load``; bfloat16 rows: the shipped ones and, for
    rows of one register chunk, every (unroll, reg_cap) and staged
    instance). bfloat16 rows take ``dot_bwd_rev_bf16``,
    ``dk`` and ``dv`` in bfloat16; its staged layouts read the receivers'
    scalars packed (:func:`_receiver_stats`, built once a call)."""
    device, args = _dot_bwd_args(indptr, col, q, k, v, mx, den, s_n, dy)
    n, heads, o, d = indptr.numel() - 1, k.shape[1], k.shape[2], v.shape[2]
    _same_rows(n, k=k)
    dk = torch.empty((n, heads, o), dtype=k.dtype, device=device)
    dv = torch.empty((n, heads, d), dtype=v.dtype, device=device)
    if n == 0 or heads == 0:
        return dk, dv
    sweep = layout is not None
    elem = dy.element_size()
    if not sweep:
        ov, dv_, vec = _dot_vectors(o, d, q, k, v, dy, dk, dv)
        layout = _dot_bwd_rev_layout(ov, dv_, n, col.numel(), vec, elem)
    fn, key = _gat_fn("dot_bwd_rev", "k8", dy)
    if elem == 4:
        _launch(fn, key, device, *args, _ptr(dk), _ptr(dv), n, heads, o, d,
                *layout, float(scale), _kernel_slope(slope), sweep=sweep)
        return dk, dv
    stats = _receiver_stats(mx, den, s_n) if layout[3] else None
    _launch(fn, key, device, *args[:8], _ptr(stats), args[8], _ptr(dk),
            _ptr(dv), n, heads, o, d, *layout, float(scale),
            _kernel_slope(slope), sweep=sweep)
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


def dot_softmax(indptr, col, q, k, v, scale, slope, raw_out=None):
    """K6 on CUDA tensors, :func:`dot_softmax_plain` on CPU tensors."""
    if _route(v) == "cpu":
        return dot_softmax_plain(indptr, col, q, k, v, scale, slope, raw_out)
    return _dot_softmax_kernel(indptr, col, q, k, v, scale, slope, raw_out)


def dot_bwd_dq(indptr, col, q, k, v, mx, den, s_n, dy, scale, slope,
               raw=None):
    """K7 on CUDA tensors, :func:`dot_bwd_dq_plain` on CPU tensors."""
    if _route(dy) == "cpu":
        return dot_bwd_dq_plain(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                                slope, raw)
    return _dot_bwd_dq_kernel(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                              slope, raw)


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
    """Gradients of the self logit and self value (edge_softmax.py:1216),
    in the self inputs' types (a bfloat16 pair is computed against the
    float32 state and rounded once, as JAX casts them)."""
    if self_logits is None:
        return None, None
    alpha = torch.exp(self_logits - mx) / den
    m_alpha = alpha if mask_self is None else alpha * mask_self
    dsl = m_alpha * (self_values * dy).sum(-1) - alpha * s_n
    return (dsl.to(self_logits.dtype),
            (m_alpha[..., None] * dy).to(self_values.dtype))


def _edge_alpha(logits, mask_e, mx, den, receivers, valid):
    """Each edge's attention weight, in edge order, and its product with
    the dropout mask; 0 for an edge ``valid`` marks invalid (in no row of
    the compacted CSR the forward walked)."""
    alpha = (torch.exp(logits - mx.index_select(0, receivers))
             / den.index_select(0, receivers))
    if valid is not None:
        alpha = torch.where(valid.reshape(valid.shape + (1,) * (
            alpha.dim() - 1)), alpha, 0.0)
    return alpha, (alpha if mask_e is None else alpha * mask_e)


def _by_position(eid, *ts):
    """Edge arrays (or None) read in CSR-position order through ``eid``
    (``graph.csr_view``'s map; None: already in that order), contiguous."""
    return tuple(None if t is None else t.contiguous() if eid is None
                 else t.index_select(0, eid.long()) for t in ts)


class EdgeSoftmaxFunction(torch.autograd.Function):
    """Softmax over in-edges and sum of EDGE values; K12 forward, eager
    backward (edge_softmax.py:182-212): the attention weights in float32
    against the float32 state, each gradient in its primal's type. The
    edge arrays come in edge order; K12 reads them by receiver-CSR
    position, through ``eid_r``; ``valid`` (the graph's ``edge_valid``, or
    None) zeroes the weights of the edges the compacted CSR left out."""

    @staticmethod
    def forward(ctx, logits, values, self_logits, self_values, mask_e,
                mask_self, indptr_r, eid_r, receivers, valid):
        logits, values, mask_e = _contiguous(logits, values, mask_e)
        num, m, s = edge_softmax(indptr_r, None,
                                 *_by_position(eid_r, logits, mask_e, values))
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values,
                                        mask_self)
        ctx.save_for_backward(logits, values, self_logits, self_values,
                              mask_e, mask_self, out, mx, den, receivers,
                              valid)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (logits, values, self_logits, self_values, mask_e, mask_self, out,
         mx, den, r, valid) = ctx.saved_tensors
        alpha, m_alpha = _edge_alpha(logits, mask_e, mx, den, r, valid)
        dy_e = dy.index_select(0, r)
        s_n = (out * dy).sum(-1)
        dl = (m_alpha * (values * dy_e).sum(-1)
              - alpha * s_n.index_select(0, r))
        dsl, dsv = _self_grads(self_logits, self_values, mask_self, mx, den,
                               s_n, dy)
        return (dl.to(logits.dtype),
                (m_alpha[..., None] * dy_e).to(values.dtype), dsl, dsv,
                None, None, None, None, None, None)


class EdgeSoftmaxNodesFunction(torch.autograd.Function):
    """Softmax over in-edges and sum of the senders' NODE values; K12
    forward. Backward: one K2 sweep over the sender CSR, every head in one
    launch, with ``w = mask * alpha`` gives both ``dv`` and the per-edge
    ``<v[s_e], dy[r_e]>`` of the logit gradient (edge_softmax.py:1756). The
    weights reach K2 in the values' type, as JAX's scatter casts them
    (``spmm.py:327``), so bfloat16 values take K2's bfloat16 variant; the
    logit gradient is taken in float32 and returned in the logits' type.
    The logits and mask come in edge order: K12 reads them through
    ``eid_r``, K2 the weights through ``eid_s`` (``graph.csr_view``'s
    maps); ``valid`` (the graph's ``edge_valid``, or None) zeroes the
    weights and logit gradients of the edges the compacted CSRs left
    out."""

    @staticmethod
    def forward(ctx, logits, values_n, self_logits, self_values, mask_e,
                mask_self, indptr_r, col_r, eid_r, indptr_s, col_s, eid_s,
                receivers, valid):
        logits, values_n, mask_e = _contiguous(logits, values_n, mask_e)
        lg_p, mask_p = _by_position(eid_r, logits, mask_e)
        num, m, s = edge_softmax(indptr_r, col_r, lg_p, mask_p, values_n)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values,
                                        mask_self)
        ctx.save_for_backward(logits, values_n, self_logits, self_values,
                              mask_e, mask_self, out, mx, den, indptr_s,
                              col_s, eid_s, receivers, valid)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (logits, values_n, self_logits, self_values, mask_e, mask_self, out,
         mx, den, indptr_s, col_s, eid_s, r, valid) = ctx.saved_tensors
        alpha, m_alpha = _edge_alpha(logits, mask_e, mx, den, r, valid)
        dy, w = _contiguous(dy, m_alpha.to(values_n.dtype))
        s_n = (out * dy).sum(-1)
        dv, dots = spmm_sddmm(indptr_s, col_s, eid_s, w, dy, values_n)
        dl = m_alpha * dots - alpha * s_n.index_select(0, r)
        if valid is not None:   # K2 leaves the dots of those edges unset
            dl = torch.where(valid.reshape(valid.shape + (1,) * (
                dl.dim() - 1)), dl, 0.0)
        dsl, dsv = _self_grads(self_logits, self_values, mask_self, mx, den,
                               s_n, dy)
        return (dl.to(logits.dtype), dv, dsl, dsv) + (None,) * 10


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
        # float32 for bfloat16 rows, as the state (edge_softmax.py:1121)
        work = _work_dtype(out.dtype)
        s_n = (out.to(work) * dy.to(work)).sum(-1)
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
        # float32 for bfloat16 rows, as the state (edge_softmax.py:1545)
        work = _work_dtype(out.dtype)
        s_n = (out.to(work) * dy.to(work)).sum(-1)
        args = (q, k, a, mx, den, s_n, dy, ctx.slope)
        need = ctx.needs_input_grad
        dq = dk = da = None
        if need[0] or need[2]:
            dq, da = gatv2_bwd_dq(indptr_r, col_r, *args)
            da = da.to(a.dtype)   # float32 sums, rounded once
        if need[1]:
            dk = gatv2_bwd_rev(indptr_s, col_s, *args)
        dsl, dsv = _self_grads(self_logits, self_values, None, mx, den, s_n,
                               dy)
        return (dq, dk, da, dsl, dsv) + (None,) * 5


class DotAttentionFunction(torch.autograd.Function):
    """Dot attention with logits ``lrelu(scale <q[r], k[s]>)`` (the plain
    dot when ``slope`` is None) and values ``v[s]``: K6 forward, K7
    (``dq``) and K8 (``dk``, ``dv``) backward (edge_softmax.py:473-783).

    Where ``q`` needs a gradient, K6 also writes each edge's raw logit, an
    ``[E, H]`` float32 residual (8 MB at E = 2M, H = 1; float32 for
    bfloat16 rows too), from which K7 takes the logits instead of building
    them again; the JAX package saves the gathered ``k`` and ``v`` rows for
    the same reason (edge_softmax.py:538-542). The backward forms ``s_n``
    in float32 and returns every gradient in its primal's type."""

    @staticmethod
    def forward(ctx, q, k, values_n, self_logits, self_values, indptr_r,
                col_r, indptr_s, col_s, scale, slope):
        q, k, values_n = _contiguous(q, k, values_n)
        # float32 for bfloat16 rows, as K6 keeps it (edge_softmax.py:320)
        raw = (torch.empty((col_r.numel(), q.shape[1]),
                           dtype=_work_dtype(q.dtype), device=q.device)
               if ctx.needs_input_grad[0] else None)
        num, m, s = dot_softmax(indptr_r, col_r, q, k, values_n, scale, slope,
                                raw)
        out, mx, den = finalize_softmax(num, m, s, self_logits, self_values)
        ctx.scale, ctx.slope = scale, slope
        ctx.save_for_backward(q, k, values_n, self_logits, self_values, out,
                              mx, den, indptr_r, col_r, indptr_s, col_s, raw)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (q, k, values_n, self_logits, self_values, out, mx, den, indptr_r,
         col_r, indptr_s, col_s, raw) = ctx.saved_tensors
        dy = dy.contiguous()
        # float32 for bfloat16 rows, as the state (edge_softmax.py:672)
        work = _work_dtype(out.dtype)
        s_n = (out.to(work) * dy.to(work)).sum(-1)
        args = (q, k, values_n, mx, den, s_n, dy, ctx.scale, ctx.slope)
        need = ctx.needs_input_grad
        dq = dot_bwd_dq(indptr_r, col_r, *args, raw) if need[0] else None
        dk = dv = None
        if need[1] or need[2]:
            dk, dv = dot_bwd_rev(indptr_s, col_s, *args)
        dsl, dsv = _self_grads(self_logits, self_values, None, mx, den, s_n,
                               dy)
        return (dq, dk, dv, dsl, dsv) + (None,) * 6


# ---- entry points ----------------------------------------------------------

def _rows(g, num_segments):
    """``(indptr, col, eid)``: the receiver CSR of ``graph.csr_view`` (a
    reversed graph's through its edge-id map, an ``edge_valid`` graph's
    compacted to the valid edges) cut to ``num_segments`` rows.

    Every receiver of an edge in it must be below ``num_segments``: the
    backward sweeps read the per-receiver state of every edge. The CSR
    groups its entries by receiver, so that holds when the cut CSR still
    holds every entry (read from the card only when the cut drops rows).
    """
    v = csr_view(g)
    n = g.num_nodes if num_segments is None else int(num_segments)
    return (_cut(v.indptr_r, n, "receiver", f"num_segments={n}"), v.col_r,
            v.eid_r)


def _senders(g, n_src: int):
    """``(indptr, col, eid)``: the sender CSR of ``graph.csr_view`` cut to
    the ``n_src`` rows of the node values; every sender must be below it
    (the forward gathers ``values_n[s_e]``)."""
    v = csr_view(g)
    return (_cut(v.indptr_s, n_src, "sender", f"{n_src} sender rows"),
            v.col_s, v.eid_s)


def _cut(indptr, n, side, what):
    """``indptr`` cut to ``n`` rows (the grouping's own rows: num_nodes on
    a graph, the halo buffer's on the sender side of a part's view across
    devices, ``parallel.ShardGraph``), raising if that drops entries."""
    rows = indptr.numel() - 1
    if n > rows:
        raise ValueError(f"{what}, but the graph has {rows} nodes")
    if n < rows and bool(indptr[n] != indptr[-1]):
        raise ValueError(f"{what}, but some edges have a {side} at or past "
                         f"it")
    return indptr[: n + 1]


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
    indptr, _, eid = _rows(g, num_segments)
    return EdgeSoftmaxFunction.apply(logits, values, self_logits,
                                     self_values, mask_e, mask_self, indptr,
                                     eid, g.receivers, g.edge_valid)


def edge_softmax_aggregate_nodes(g, logits, values_n, *, num_segments=None,
                                 self_logits=None, self_values=None,
                                 dropout_masks=None):
    """:func:`edge_softmax_aggregate` of the senders' node values
    ``values_n [N_src, H, D]``: edge ``e`` contributes ``values_n[s_e]``."""
    mask_e, mask_self = dropout_masks or (None, None)
    return EdgeSoftmaxNodesFunction.apply(
        logits, values_n, self_logits, self_values, mask_e, mask_self,
        *_rows(g, num_segments), *_senders(g, values_n.shape[0]),
        g.receivers, g.edge_valid)


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
        pi, pj, values_n, self_logits, self_values, *_rows(g, n)[:2],
        *_senders(g, values_n.shape[0])[:2], float(slope))


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
        q, k, a, self_logits, self_values, *_rows(g, n)[:2],
        *_senders(g, k.shape[0])[:2], float(slope))


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
        q, k, values_n, self_logits, self_values, *_rows(g, n)[:2],
        *_senders(g, values_n.shape[0])[:2], float(scale),
        None if slope is None else float(slope))
