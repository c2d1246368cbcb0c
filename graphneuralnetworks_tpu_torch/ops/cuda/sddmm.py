"""Per-edge endpoint dots on the card: kernel K13, its plain version,
autograd.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/sddmm.py``. The TPU
kernel distributes receiver rows to edge slots by a one-hot matmul over
128x512 blocks and ungroups the result by a gather; here a warp takes
(receiver, head) pairs of the receiver CSR and writes each edge's dot in
edge order (``csrc/sddmm.cu``):

- K13 ``sddmm_csr``: ``out[e, h] = <xi[r_e, h], xj[s_e, h]>``, all heads in
  one launch (one per chunk of 128 floats of a wider row); a warp takes
  four (receiver, head) pairs in turn and loads the next pair's operands
  while the current pair's gathers are in flight.

Its gradient is two weighted SpMMs on K1 (sddmm.py:143-155): ``dxi[r] =
sum_{e -> r} dl_e xj[s_e]`` over the receiver CSR and ``dxj[s] = sum_{e:
s_e = s} dl_e xi[r_e]`` over the sender CSR, once per head.

bfloat16 rows take ``sddmm_csr_bf16``: each dot summed in float32 from the
widened values and rounded once to bfloat16, as the TPU kernel rounds its
f32 sum of a lane block; the backward is K1's bfloat16 variant, weighted by
the bfloat16 ``dl``. The plain version computes bfloat16 the same way.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``sddmm_plain``); a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches (``k13_bf16``: the bfloat16 variant),
and nothing else adds to it. Unlike
the JAX package, which takes its kernel only at widths above 256, the card
takes K13 at every width.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from .build import load
from .edge_softmax import _cut
from .spmm import (_call_on, _check, _entries, _ptr, _raise_on_error, _route,
                   _row_ids, _row_vectors, _work_dtype, spmm_csr)

__all__ = ["launches", "sddmm_csr", "sddmm_plain", "SddmmFunction", "sddmm"]

launches = {"k13": 0, "k13_bf16": 0}

# K13 holds a chunk of 32 vectors a lane; the chunks of a wider row launch
# in turn (csrc/sddmm.cu)
_CHUNK_VECTORS = 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("sddmm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sddmm_csr_f32.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.sddmm_csr_f32.restype = i32
    lib.sddmm_csr_bf16.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.sddmm_csr_bf16.restype = i32
    lib.gnn_cuda_error_string.argtypes = [i32]
    lib.gnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sddmm_plain(indptr, col, xi, xj):
    """K13's function over the receiver CSR: ``out[e] = <xi[r_e], xj[col_e]>``
    per head, ``xi [n, H, D]`` and ``xj [N_src, H, D]`` -> ``[E, H]`` in CSR
    position order. bfloat16 rows are multiplied and summed in float32 and
    each dot rounded once. Positions past the CSR's entries
    (``spmm._entries``) get 0."""
    n = _entries(indptr)
    rows = _row_ids(indptr, n)
    work = _work_dtype(xi.dtype)
    out = xi.new_zeros((col.numel(), xi.shape[1]))
    out[:n] = (xi.to(work).index_select(0, rows)
               * xj.to(work).index_select(0, col[:n].long())).sum(-1)
    return out


def _sddmm_kernel(indptr, col, xi, xj):
    """K13: ``sddmm_csr_f32``, or ``sddmm_csr_bf16`` for bfloat16 ``xi``
    and ``xj`` (a mix raises ``TypeError``), with a float32 ``[E, H]``
    scratch for the partial dots where a row spans several chunks."""
    device, dtype = xi.device, xi.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K13 kernel takes float32 or bfloat16 rows, got "
                        f"{dtype}")
    _check(indptr, "indptr", torch.int32, device)
    _check(col, "col", torch.int32, device)
    for name, t in (("xi", xi), ("xj", xj)):
        _check(t, name, dtype, device)
        if t.dim() != 3:
            raise ValueError(f"{name} must be [rows, H, D], got "
                             f"{tuple(t.shape)}")
    if xi.shape[1:] != xj.shape[1:]:
        raise ValueError(f"xi {tuple(xi.shape)} and xj {tuple(xj.shape)} "
                         "disagree on H or D")
    n, (_, heads, d) = indptr.numel() - 1, xi.shape
    if xi.shape[0] != n:
        raise ValueError(f"xi has {xi.shape[0]} rows, the CSR {n}")
    out = xi.new_empty((col.numel(), heads))
    if n == 0 or heads == 0 or col.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    lib = _lib()
    fv, vec_bytes = _row_vectors(d, xi.element_size(), xi, xj)
    if dtype == torch.bfloat16:
        acc = (torch.empty(out.shape, dtype=torch.float32, device=device)
               if fv > _CHUNK_VECTORS else None)
        code = _call_on(device, lib.sddmm_csr_bf16, _ptr(indptr), _ptr(col),
                        _ptr(xi), _ptr(xj), _ptr(out), _ptr(acc), n, heads,
                        d, vec_bytes)
        fn, key = "sddmm_csr_bf16", "k13_bf16"
    else:
        code = _call_on(device, lib.sddmm_csr_f32, _ptr(indptr), _ptr(col),
                        _ptr(xi), _ptr(xj), _ptr(out), n, heads, d,
                        vec_bytes)
        fn, key = "sddmm_csr_f32", "k13"
    launches[key] += 1
    _raise_on_error(lib, code, fn)
    return out


def sddmm_csr(indptr, col, xi, xj):
    """K13 on CUDA tensors, :func:`sddmm_plain` on CPU tensors."""
    if _route(xj) == "cpu":
        return sddmm_plain(indptr, col, xi, xj)
    return _sddmm_kernel(indptr, col, xi, xj)


class SddmmFunction(torch.autograd.Function):
    """``out[e, h] = <xi[r_e, h], xj[s_e, h]>`` for ``xi [n, H, D]``, ``xj
    [N_src, H, D]``, in edge order: K13 forward over the receiver CSR,
    whose positions ``eid_r`` maps to edge ids (a reversed graph's; None:
    the positions are the edge ids), the dots written back through it;
    backward K1 over the receiver CSR for ``dxi`` and over the sender CSR
    for ``dxj``, per head, each reading ``dl`` through its map, in the
    rows' type (bfloat16 rows: K1's bfloat16 variant, weighted by the
    bfloat16 ``dl``)."""

    @staticmethod
    def forward(ctx, xi, xj, indptr_r, col_r, eid_r, indptr_s, col_s,
                eid_s):
        xi, xj = xi.contiguous(), xj.contiguous()
        ctx.save_for_backward(xi, xj, indptr_r, col_r, eid_r, indptr_s,
                              col_s, eid_s)
        out = sddmm_csr(indptr_r, col_r, xi, xj)
        if eid_r is not None:
            out = torch.empty_like(out).index_copy_(0, eid_r.long(), out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dl):
        (xi, xj, indptr_r, col_r, eid_r, indptr_s, col_s,
         eid_s) = ctx.saved_tensors
        need_i, need_j = ctx.needs_input_grad[:2]
        dxi = torch.empty_like(xi) if need_i else None
        dxj = torch.empty_like(xj) if need_j else None
        for h in range(xi.shape[1]):
            w = dl[:, h].contiguous()
            if need_i:
                dxi[:, h] = spmm_csr(indptr_r, col_r, eid_r, w,
                                     xj[:, h].contiguous())
            if need_j:
                dxj[:, h] = spmm_csr(indptr_s, col_s, eid_s, w,
                                     xi[:, h].contiguous())
        return (dxi, dxj) + (None,) * 6


def sddmm(g, xi, xj):
    """``<xi[r_e], xj[s_e]>`` for every edge of ``g``, in edge order.

    ``xi [n, *H, D]`` holds the receivers, ``xj [N_src, *H, D]`` the
    senders; the head dimensions ``*H`` (none, one or more) flatten into
    one for the kernel. Returns ``[E, *H]``. Every edge is computed, those
    that ``edge_valid`` marks invalid too, as the JAX package's
    ``apply_edges`` and ``dot_attention_logits`` read no mask: K13 walks
    the graph's own CSRs, not the compacted ones.
    """
    shape_h, d = tuple(xi.shape[1:-1]), xi.shape[-1]
    if tuple(xj.shape[1:]) != shape_h + (d,):
        raise ValueError(f"xi {tuple(xi.shape)} and xj {tuple(xj.shape)} "
                         "disagree on the head dimensions or D")
    h = math.prod(shape_h)
    n = xi.shape[0]
    out = SddmmFunction.apply(
        xi.reshape(n, h, d), xj.reshape(xj.shape[0], h, d),
        _cut(g.indptr_r, n, "receiver", f"num_segments={n}"), g.col_r,
        g.eid_r, _cut(g.indptr_s, xj.shape[0], "sender",
                      f"{xj.shape[0]} sender rows"), g.col_s, g.eid_s)
    return out.reshape((out.shape[0],) + shape_h)
