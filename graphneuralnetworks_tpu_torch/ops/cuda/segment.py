"""Per-row max and min over a CSR on the card: kernel K14 and its
backward, their plain versions, autograd.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/edge_softmax.py:
segment_max_grouped``. The TPU kernel takes a running max of ``[E, H]``
logits per 128-row receiver block through a one-hot mask; here a warp
takes several narrow CSR rows (``_rows_per_warp``) or one (row, chunk of
columns) of a wide one, and walks the rows' entries, which are contiguous
rows of the data (``csrc/segment.cu``):

- K14 ``segment_max_csr`` / ``segment_min_csr``: ``out[r] = max (min) of
  data[indptr[r]:indptr[r+1]]`` over the leading axis, ``-inf`` (``+inf``)
  for a row without entries, NaN where an entry is NaN.
- its backward ``segment_max_bwd_csr``: the cotangent of each output split
  evenly over the entries that equal it (ties), 0 for the others. JAX's
  K14 has no gradient of its own; this is the gradient JAX gives its
  segment max (``ops.segment.extreme_grad``: in bfloat16 the tie count
  stops at 256, as JAX's scatter-add of ones does), without the two
  ``[rows, F]`` gathers of ``out`` and ``dy`` an eager backward needs.

Both take float32 or bfloat16 (``*_bf16``; every operand of one type, a
mix raises ``TypeError``): a max or min of bfloat16 values is exact, and
the backward's share ``dy / count`` is divided in float32 and rounded once,
the bits of the plain version's bfloat16 division.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``*_plain``, the port's ``ops.segment`` reductions over ids expanded from
``indptr``); a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches (``k14_bf16``, ``k14_bwd_bf16``: the bfloat16
variants), and nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from .. import segment as _segment
from .build import load
from .spmm import (_INT32_MAX, _call_on, _check, _entries, _ptr,
                   _raise_on_error, _route, _row_ids, _row_vectors)

__all__ = ["launches", "segment_max_csr", "segment_min_csr",
           "segment_max_bwd_csr", "segment_max_plain", "segment_min_plain",
           "segment_max_bwd_plain", "SegmentMaxFunction"]

launches = {"k14": 0, "k14_bwd": 0, "k14_bf16": 0, "k14_bwd_bf16": 0}


# Entries of a row that each edge group of K14 walks at least, on average,
# in the forward and in the backward (which reads each entry twice): fewer
# rows per warp leave lanes idle, more leave too few loads in flight per
# lane. Measured by chip_smoke.py --sweep, which times every choice.
_FWD_ENTRIES_PER_GROUP = 4
_BWD_ENTRIES_PER_GROUP = 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("segment")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in ("f32", "bf16"):
        fwd = getattr(lib, f"segment_max_csr_{sfx}")
        fwd.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"segment_max_bwd_csr_{sfx}")
        bwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        bwd.restype = i32
    lib.gnn_cuda_error_string.argtypes = [i32]
    lib.gnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---- plain PyTorch versions (the CPU path, and the reference on the card) --

def _extreme_plain(op_min: bool, indptr, data):
    n = _entries(indptr)
    return _segment._segment_extreme(op_min, data[:n], _row_ids(indptr, n),
                                     indptr.numel() - 1, empty_value=None)


def segment_max_plain(indptr, data):
    """K14's function: ``out[r] = max(data[indptr[r]:indptr[r+1]])`` over
    the leading axis, ``-inf`` for a row without entries."""
    return _extreme_plain(False, indptr, data)


def segment_min_plain(indptr, data):
    """The same with min, ``+inf`` for a row without entries."""
    return _extreme_plain(True, indptr, data)


def segment_max_bwd_plain(indptr, data, out, dy):
    """``ddata[e] = dy[r] * (data[e] == out[r]) / count`` for entry ``e`` of
    row ``r``, ``count`` the entries of the row equal to ``out[r]`` (0 where
    there are none: a NaN output), at most 256 in bfloat16 as JAX counts
    (``ops.segment.extreme_grad``). In bfloat16 the share is one bfloat16
    division, rounded once. Rows of ``data`` past the CSR's entries (a
    compacted view's: ``spmm._entries``) get 0."""
    n = _entries(indptr)
    return torch.cat([
        _segment.extreme_grad(data[:n], out, _row_ids(indptr, n), dy),
        data.new_zeros((data.shape[0] - n,) + data.shape[1:])])


# ---- kernel wrappers -------------------------------------------------------

def _check_launch(indptr, *dense) -> bool:
    """K14's operands: ``dense`` of one float type, float32 or bfloat16 (a
    mix raises ``TypeError``), int32 ``indptr``, all contiguous on one
    device. Returns whether they are bfloat16."""
    device, dtype = dense[0].device, dense[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K14 kernels take float32 or bfloat16, got "
                        f"{dtype}")
    _check(indptr, "indptr", torch.int32, device)
    for i, t in enumerate(dense):
        _check(t, f"dense operand {i}", dtype, device)
    if dense[0].shape[0] > _INT32_MAX:
        raise ValueError("the CUDA kernels index entries with int32: at most "
                         f"{_INT32_MAX} rows of data")
    return dtype == torch.bfloat16


def _rows_per_warp(fv: int, n_rows: int, entries: int,
                   per_group: int) -> int:
    """log2 of the CSR rows one warp of K14 or its backward takes, for rows
    of ``fv`` column vectors and ``entries / n_rows`` entries on average:
    the row's lanes split into the most edge groups (a power of two, each
    of ``G`` lanes, ``G`` the vector count rounded up to a power of two)
    that still walk ``per_group`` entries each, and the warp's 32 lanes
    take as many such rows as fit. Rows of 32 vectors or more take one warp
    per row (0)."""
    log_g = min((fv - 1).bit_length(), 5)
    if log_g == 5 or n_rows == 0:
        return 0
    mean, groups = entries / n_rows, 1
    while groups < 32 >> log_g and mean / (2 * groups) >= per_group:
        groups *= 2
    return 5 - log_g - (groups.bit_length() - 1)


def _segment_extreme_kernel(op_min: bool, indptr, data, log_rows=None):
    bf16 = _check_launch(indptr, data)
    n_rows = indptr.numel() - 1
    out = data.new_empty((n_rows, *data.shape[1:]))
    f = math.prod(data.shape[1:])
    if n_rows == 0 or f == 0:
        return out
    fv, vec_bytes = _row_vectors(f, data.element_size(), data, out)
    if log_rows is None:
        log_rows = _rows_per_warp(fv, n_rows, data.shape[0],
                                  _FWD_ENTRIES_PER_GROUP)
    lib = _lib()
    fn = f"segment_max_csr_{'bf16' if bf16 else 'f32'}"
    code = _call_on(data.device, getattr(lib, fn), _ptr(indptr), _ptr(data),
                    _ptr(out), n_rows, f, int(op_min),
                    vec_bytes, log_rows)
    _raise_on_error(lib, code, fn)
    launches["k14_bf16" if bf16 else "k14"] += 1
    return out


def _segment_max_bwd_kernel(indptr, data, out, dy, log_rows=None):
    bf16 = _check_launch(indptr, data, out, dy)
    n_rows = indptr.numel() - 1
    if out.shape != dy.shape or out.shape[1:] != data.shape[1:] \
            or out.shape[0] != n_rows:
        raise ValueError(f"data {tuple(data.shape)}, out {tuple(out.shape)} "
                         f"and dy {tuple(dy.shape)} do not match a CSR of "
                         f"{n_rows} rows")
    ddata = torch.empty_like(data)
    f = math.prod(data.shape[1:])
    if n_rows == 0 or f == 0 or data.shape[0] == 0:
        return ddata.zero_()
    fv, vec_bytes = _row_vectors(f, data.element_size(), data, out, dy,
                                 ddata)
    if log_rows is None:
        log_rows = _rows_per_warp(fv, n_rows, data.shape[0],
                                  _BWD_ENTRIES_PER_GROUP)
    lib = _lib()
    fn = f"segment_max_bwd_csr_{'bf16' if bf16 else 'f32'}"
    code = _call_on(data.device, getattr(lib, fn), _ptr(indptr), _ptr(data),
                    _ptr(out), _ptr(dy), _ptr(ddata), n_rows, f,
                    vec_bytes, log_rows)
    _raise_on_error(lib, code, fn)
    launches["k14_bwd_bf16" if bf16 else "k14_bwd"] += 1
    return ddata


def segment_max_csr(indptr, data):
    """K14 (max) on a CUDA tensor, :func:`segment_max_plain` on a CPU one.

    ``indptr`` (``int32[R + 1]``) groups the rows of ``data [rows, *F]`` in
    order; its last entry must be ``rows``. Returns ``[R, *F]``."""
    if _route(data) == "cpu":
        return segment_max_plain(indptr, data)
    return _segment_extreme_kernel(False, indptr, data)


def segment_min_csr(indptr, data):
    """K14 (min) on a CUDA tensor, :func:`segment_min_plain` on a CPU one."""
    if _route(data) == "cpu":
        return segment_min_plain(indptr, data)
    return _segment_extreme_kernel(True, indptr, data)


def segment_max_bwd_csr(indptr, data, out, dy):
    """K14's backward on CUDA tensors, :func:`segment_max_bwd_plain` on CPU
    tensors; the same for max and min."""
    if _route(data) == "cpu":
        return segment_max_bwd_plain(indptr, data, out, dy)
    return _segment_max_bwd_kernel(indptr, data, out, dy)


class SegmentMaxFunction(torch.autograd.Function):
    """``apply(data, indptr, op_min, eid=None)``: ``out[r] = max``
    (``op_min``: min) ``of data[indptr[r]:indptr[r+1]]`` over the leading
    axis, ``-inf`` (``+inf``) for rows without entries: K14 forward, its
    backward kernel backward.

    ``eid`` maps each CSR position to the row of ``data`` it reads (the
    edge ids of ``graph.csr_view``: a reversed graph's, a compacted one's),
    None where they are the same: the rows are gathered into CSR order
    before K14 and the backward's written back through it. The rows that a
    compacted view leaves out get whatever the backward kernel left in its
    unfilled positions: the caller masks them (``ops.segment`` takes the
    graph's ``edge_valid`` as its mask, and the mask's gradient is 0
    there)."""

    @staticmethod
    def forward(ctx, data, indptr, op_min, eid=None):
        data = (data.contiguous() if eid is None
                else data.index_select(0, eid.long()))
        out = (segment_min_csr if op_min else segment_max_csr)(indptr, data)
        ctx.save_for_backward(indptr, data, out, eid)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        indptr, data, out, eid = ctx.saved_tensors
        dd = segment_max_bwd_csr(indptr, data, out, dy.contiguous())
        if eid is not None:
            dd = torch.empty_like(dd).index_copy_(0, eid.long(), dd)
        return dd, None, None, None
