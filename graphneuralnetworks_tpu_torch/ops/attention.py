"""Attention aggregation over in-edges, with a virtual self-loop.

Counterpart of ``graphneuralnetworks_tpu/ops/attention.py`` (reference
GNNlib conv.jl:112-150 and utils.jl:84-97). The self-loop never becomes an
edge: its logit and value enter each node's softmax analytically, which is
the softmax over {in-edges} and {self}. Attention dropout is a pair of
multiplicative masks (0 or 1/(1-p)) on the normalised weights; the softmax
denominator is not dropped.

Dispatch: on CUDA tensors every function goes to the kernels of
:mod:`.cuda.edge_softmax` (K3-K5 for :func:`gat_attention` and K9-K11 for
:func:`gatv2_attention` without dropout, K6-K8 for :func:`dot_attention`,
K12 otherwise) or :mod:`.cuda.sddmm` (K13 for :func:`dot_attention_logits`,
all heads in one launch), at any number of head dimensions; a shape the
kernels cannot take raises. Only CPU tensors take the plain path below, the
counterpart of the JAX package's XLA path.

bfloat16: on the card only :func:`gat_attention` without dropout takes it
(K3-K5); every other kernel route raises ``TypeError``. The plain path
computes bfloat16 values as those kernels do: logits, softmax and sums in
float32, the output rounded once to bfloat16.
"""

from __future__ import annotations

import functools
import math

import torch

from ..graph import GraphTuple, no_edge_valid
from .cuda.edge_softmax import (dot_attention_nodes, edge_softmax_aggregate,
                                edge_softmax_aggregate_nodes,
                                gat_attention_nodes, gatv2_attention_nodes,
                                lrelu)
from .cuda.sddmm import sddmm
from .cuda.spmm import _work_dtype
from .msgpass import to_src_space
from .segment import gather, segment_max, segment_sum

__all__ = ["attention_aggregate", "gat_attention", "gatv2_attention",
           "dot_attention", "dot_attention_logits"]


def _kernel_route(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _flat_heads(t, *tail, h):
    """``[rows, *H, *tail]`` -> ``[rows, h, *tail]`` (None stays None)."""
    return None if t is None else t.reshape(t.shape[0], h, *tail)


def _aggregate_kernels(g, logits, values, self_logits, self_values,
                       dropout_masks, n, node_values):
    """:func:`attention_aggregate` on the kernels: the head dimensions
    ``*H`` (none, one or more) flatten into one for K12 and come back."""
    shape_h, d = tuple(logits.shape[1:]), values.shape[-1]
    heads = functools.partial(_flat_heads, h=math.prod(shape_h))
    dm = dropout_masks
    if dm is not None:
        dm = (heads(dm[0]), heads(dm[1]))
    fn = edge_softmax_aggregate_nodes if node_values else edge_softmax_aggregate
    out = fn(g, heads(logits), heads(values, d), num_segments=n,
             self_logits=heads(self_logits), self_values=heads(self_values, d),
             dropout_masks=dm)
    return out.reshape((out.shape[0],) + shape_h + (d,))


def gat_attention(g: GraphTuple, pi, pj, values, slope: float, *,
                  self_logits=None, self_values=None, dropout_masks=None,
                  num_segments=None, pj_weight=None):
    """GAT attention with logits ``leaky_relu(pi[r_e] + pj[s_e], slope)``.

    ``pi [n_dst, H]`` / ``pj [N_src, H]`` are the receiver and sender logit
    projections and ``values [N_src, H, D]`` the senders' node values. On
    the card without dropout the logits are computed inside the kernels
    (:func:`~.cuda.edge_softmax.gat_attention_nodes`); otherwise they are
    gathered and :func:`attention_aggregate` takes over. ``pj_weight`` is
    accepted for the JAX package's signature and not used.
    """
    no_edge_valid(g, "gat_attention")
    pj = to_src_space(g, pj)   # identity unless g is a part's view
    values = to_src_space(g, values)
    if _kernel_route(values) and dropout_masks is None:
        return gat_attention_nodes(g, pi, pj, values, slope,
                                   self_logits=self_logits,
                                   self_values=self_values,
                                   num_segments=num_segments,
                                   pj_weight=pj_weight)
    work = _work_dtype(values.dtype)   # float32 logits for bfloat16
    logits = lrelu(gather(pi.to(work), g.receivers)
                   + gather(pj.to(work), g.senders), slope)
    return attention_aggregate(g, logits, values, self_logits=self_logits,
                               self_values=self_values,
                               dropout_masks=dropout_masks,
                               num_segments=num_segments, node_values=True)


def gatv2_attention(g: GraphTuple, q, k, a, slope: float, *,
                    self_logits=None, self_values=None, dropout_masks=None,
                    num_segments=None):
    """GATv2 attention: logits ``<a_h, leaky_relu(q[r_e] + k[s_e])>``, values
    ``k[s_e]``.

    ``q [n_dst, H, O]`` / ``k [N_src, H, O]`` are the receiver and sender
    projections and ``a [O, H]`` the attention weights. On the card without
    dropout the logits are computed inside the kernels
    (:func:`~.cuda.edge_softmax.gatv2_attention_nodes`); otherwise they are
    gathered and :func:`attention_aggregate` takes over.
    """
    no_edge_valid(g, "gatv2_attention")
    k = to_src_space(g, k)
    if _kernel_route(k) and dropout_masks is None:
        return gatv2_attention_nodes(g, q, k, a, slope,
                                     self_logits=self_logits,
                                     self_values=self_values,
                                     num_segments=num_segments)
    wx = gather(q, g.receivers) + gather(k, g.senders)
    logits = torch.einsum("ehf,fh->eh", lrelu(wx, slope), a)
    return attention_aggregate(g, logits, k, self_logits=self_logits,
                               self_values=self_values,
                               dropout_masks=dropout_masks,
                               num_segments=num_segments, node_values=True)


def dot_attention(g: GraphTuple, q, k, values, scale: float = 1.0, *,
                  self_logits=None, self_values=None, num_segments=None):
    """Attention with logits ``scale * <q[r_e], k[s_e]>`` (Transformer,
    AGNN).

    ``q [n_dst, *H, O]`` / ``k [N_src, *H, O]`` are the receiver and sender
    projections and ``values [N_src, *H, D]`` the senders' node values;
    ``self_logits [n_dst, *H]`` (already scaled) and ``self_values`` add the
    virtual self-loop. On the card the logits are computed inside the
    kernels (:func:`~.cuda.edge_softmax.dot_attention_nodes`, the head
    dimensions flattened into one); otherwise
    :func:`dot_attention_logits` and :func:`attention_aggregate` take over.
    """
    no_edge_valid(g, "dot_attention")
    k = to_src_space(g, k)
    values = to_src_space(g, values)
    if _kernel_route(values):
        shape_h, d = tuple(q.shape[1:-1]), values.shape[-1]
        heads = functools.partial(_flat_heads, h=math.prod(shape_h))
        out = dot_attention_nodes(
            g, heads(q, q.shape[-1]), heads(k, k.shape[-1]), heads(values, d),
            scale, self_logits=heads(self_logits),
            self_values=heads(self_values, d), num_segments=num_segments)
        return out.reshape((out.shape[0],) + shape_h + (d,))
    logits = dot_attention_logits(g, q, k) * scale
    return attention_aggregate(g, logits, values, self_logits=self_logits,
                               self_values=self_values,
                               num_segments=num_segments, node_values=True)


def dot_attention_logits(g: GraphTuple, qi, kj):
    """Per-edge endpoint dots ``<qi[r_e], kj[s_e]>``: ``[N, *H, O]`` ->
    ``[E, *H]`` (``[N, O]`` -> ``[E]``). On the card, one launch of K13
    for all heads (:func:`~.cuda.sddmm.sddmm`)."""
    no_edge_valid(g, "dot_attention_logits")
    kj = to_src_space(g, kj)
    if _kernel_route(kj):
        return sddmm(g, qi, kj)
    return (gather(qi, g.receivers) * gather(kj, g.senders)).sum(-1)


def attention_aggregate(g: GraphTuple, logits, values, *, self_logits=None,
                        self_values=None, dropout_masks=None,
                        num_segments=None, node_values: bool = False):
    """Softmax ``logits`` over each node's in-edges and sum ``values``.

    Args:
      logits: ``[E, *H]`` scores, one row per edge (in the graph's order).
      values: ``[E, *H, D]`` messages or, with ``node_values=True``,
        ``[N_src, *H, D]`` sender node values (edge ``e`` takes
        ``values[s_e]``).
      self_logits/self_values: optional ``[n, *H]`` / ``[n, *H, D]`` virtual
        self-loop terms.
      dropout_masks: optional ``(mask_e [E, *H], mask_self [n, *H] or
        None)`` scales of the normalised attention weights.
      num_segments: the number of receiving nodes ``n`` (default: all).

    Returns ``[n, *H, D]``.
    """
    no_edge_valid(g, "attention_aggregate")
    n = num_segments if num_segments is not None else g.num_nodes
    if node_values:
        values = to_src_space(g, values)
    if values.dim() != logits.dim() + 1:
        raise ValueError(f"values {tuple(values.shape)} must have one more "
                         f"dimension than logits {tuple(logits.shape)}")
    if _kernel_route(values):
        return _aggregate_kernels(g, logits, values, self_logits,
                                  self_values, dropout_masks, n, node_values)
    work = _work_dtype(values.dtype)
    if work != values.dtype:   # bfloat16: in float32, rounded once
        def up(t):
            return None if t is None else t.to(work)
        out = attention_aggregate(
            g, up(logits), up(values), self_logits=up(self_logits),
            self_values=up(self_values), num_segments=num_segments,
            node_values=node_values,
            dropout_masks=None if dropout_masks is None
            else tuple(up(m) for m in dropout_masks))
        return out.to(values.dtype)

    r = g.receivers
    if node_values:
        values = gather(values, g.senders)
    mx = segment_max(logits, r, n, empty_value=None)   # -inf: no in-edges
    if self_logits is not None:
        mx = torch.maximum(mx, self_logits)
    mx = mx.masked_fill(torch.isneginf(mx), 0.0)
    ex = torch.exp(logits - gather(mx, r))
    denom = segment_sum(ex, r, n)
    if self_logits is not None:
        ex_self = torch.exp(self_logits - mx)
        denom = denom + ex_self
    denom = denom.clamp(min=torch.finfo(ex.dtype).tiny)
    alpha = ex / gather(denom, r)
    if dropout_masks is not None:
        alpha = alpha * dropout_masks[0]
    out = segment_sum(alpha[..., None] * values, r, n)
    if self_logits is not None:
        alpha_self = ex_self / denom
        if dropout_masks is not None and dropout_masks[1] is not None:
            alpha_self = alpha_self * dropout_masks[1]
        out = out + alpha_self[..., None] * self_values
    return out
