"""CSR SpMM on the card: kernels K1 and K2, their plain versions, autograd.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/spmm.py``. The TPU
kernels scatter through one-hot matmuls over 128x512 receiver blocks; here
the graph carries two CSR groupings (``graph.py``) and each kernel gives one
warp to one output row (``csrc/spmm.cu``):

- K1 ``spmm_csr``: ``y[i] = sum_k w[eid[k]] * x[col[k]]`` over row ``i``.
  Over the receiver CSR it is the forward SpMM; over the sender CSR it is
  the backward for ``x``.
- K2 ``spmm_sddmm``: over the sender CSR, ``dx[s] = sum w_e * dy[r_e]`` and
  ``dw_e = <dy[r_e], x[s]>`` in one sweep: the weighted backward.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``spmm_plain`` / ``spmm_sddmm_plain``); a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches, and nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from .build import load

__all__ = ["launches", "spmm_csr", "spmm_sddmm", "spmm_plain",
           "spmm_sddmm_plain", "SpmmFunction", "spmm"]

launches = {"k1": 0, "k2": 0}

_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("spmm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spmm_csr_f32.argtypes = [ptr] * 6 + [i32, i32, ptr]
    lib.spmm_csr_f32.restype = i32
    lib.spmm_sddmm_csr_f32.argtypes = [ptr] * 8 + [i32, i32, ptr]
    lib.spmm_sddmm_csr_f32.restype = i32
    lib.gnn_cuda_error_string.argtypes = [i32]
    lib.gnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` the current CUDA device and
    ``stream`` its current stream (a raw ``cudaStream_t``): what ``with
    torch.cuda.device(device)`` around ``torch.cuda.current_stream()``
    gives, without the context manager's host cost when ``device`` is
    current already."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _raise_on_error(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.gnn_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check(t, name: str, dtype, device) -> None:
    if t is None:
        return
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(indptr, col, eid, w, *dense) -> None:
    device = dense[0].device
    for i, t in enumerate(dense):
        _check(t, f"dense operand {i}", torch.float32, device)
        if t.dim() != 2:
            raise ValueError(f"dense operand {i} must be 2-D, got "
                             f"{tuple(t.shape)}")
    for name, t in (("indptr", indptr), ("col", col), ("eid", eid)):
        _check(t, name, torch.int32, device)
    _check(w, "w", torch.float32, device)
    n_edges = col.numel() if col is not None else dense[0].shape[0]
    if n_edges > _INT32_MAX or dense[0].shape[1] > _INT32_MAX:
        raise ValueError("the CUDA kernels index edges with int32: at most "
                         f"{_INT32_MAX} edges")


# ---- plain PyTorch versions (the CPU path, and the reference on the card) --

def _row_ids(indptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    n_rows = indptr.numel() - 1
    counts = torch.diff(indptr).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), counts,
        output_size=n_edges)


def spmm_plain(indptr, col, eid, w, x):
    """``y[i] = sum_{k in [indptr[i], indptr[i+1])} w[eid[k]] * x[col[k]]``.

    ``col=None`` reads ``x[k]`` (rows already in grouping order),
    ``eid=None`` reads ``w[k]``, ``w=None`` is unweighted.
    """
    n_edges = col.numel() if col is not None else x.shape[0]
    rows = _row_ids(indptr, n_edges)
    src = x if col is None else x.index_select(0, col.long())
    if w is not None:
        we = w if eid is None else w.index_select(0, eid.long())
        src = src * we.to(src.dtype).unsqueeze(-1)
    out = x.new_zeros((indptr.numel() - 1, x.shape[1]))
    return out.index_add_(0, rows, src)


def spmm_sddmm_plain(indptr, col, eid, w, dy, x):
    """Over a sender CSR: ``(dx, dw)`` with ``dx[s] = sum w_e dy[col_e]`` and
    ``dw[eid_e] = <dy[col_e], x[s]>`` (unweighted). ``dx`` has ``x``'s rows.
    """
    n_edges = col.numel()
    rows = _row_ids(indptr, n_edges)
    dyv = dy.index_select(0, col.long())
    ids = (eid.long() if eid is not None
           else torch.arange(n_edges, device=dy.device))
    scaled = dyv if w is None else dyv * w.index_select(0, ids).to(
        dyv.dtype).unsqueeze(-1)
    dx = x.new_zeros(x.shape).index_add_(0, rows, scaled)
    dots = (dyv * x.index_select(0, rows)).sum(-1)
    dw = dots.new_empty(n_edges).index_copy_(0, ids, dots)
    return dx, dw


# ---- kernel wrappers -------------------------------------------------------

def _spmm_csr_kernel(indptr, col, eid, w, x):
    _check_launch(indptr, col, eid, w, x)
    n_rows, d = indptr.numel() - 1, x.shape[1]
    y = torch.empty((n_rows, d), dtype=x.dtype, device=x.device)
    if n_rows == 0 or d == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spmm_csr_f32(_ptr(indptr), _ptr(col), _ptr(eid), _ptr(w),
                                _ptr(x), _ptr(y), n_rows, d, stream)
    launches["k1"] += 1
    _raise_on_error(lib, code, "spmm_csr_f32")
    return y


def _spmm_sddmm_kernel(indptr, col, eid, w, dy, x):
    _check_launch(indptr, col, eid, w, dy, x)
    n_rows, d = indptr.numel() - 1, x.shape[1]
    if x.shape[0] != n_rows or dy.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} / dy {tuple(dy.shape)} do not "
                         f"match a sender CSR of {n_rows} rows")
    dx = torch.empty_like(x)
    dw = torch.empty(col.numel(), dtype=torch.float32, device=x.device)
    if n_rows == 0 or col.numel() == 0:
        return dx.zero_(), dw
    if d == 0:
        return dx, dw.zero_()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spmm_sddmm_csr_f32(_ptr(indptr), _ptr(col), _ptr(eid),
                                      _ptr(w), _ptr(dy), _ptr(x), _ptr(dx),
                                      _ptr(dw), n_rows, d, stream)
    launches["k2"] += 1
    _raise_on_error(lib, code, "spmm_sddmm_csr_f32")
    return dx, dw


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no SpMM for tensors on {t.device}")


def spmm_csr(indptr, col, eid, w, x):
    """K1 on a CUDA tensor, :func:`spmm_plain` on a CPU tensor."""
    if _route(x) == "cpu":
        return spmm_plain(indptr, col, eid, w, x)
    return _spmm_csr_kernel(indptr, col, eid, w, x)


def spmm_sddmm(indptr, col, eid, w, dy, x):
    """K2 on CUDA tensors, :func:`spmm_sddmm_plain` on CPU tensors."""
    if _route(x) == "cpu":
        return spmm_sddmm_plain(indptr, col, eid, w, dy, x)
    return _spmm_sddmm_kernel(indptr, col, eid, w, dy, x)


class SpmmFunction(torch.autograd.Function):
    """``y[i] = sum_{e: r_e = i} w_e * x[s_e]`` with a kernel backward.

    Forward: K1 over the receiver CSR. Backward: K2 over the sender CSR when
    ``w`` needs a gradient, else K1 over the sender CSR. ``x`` may have
    fewer rows than the graph has nodes (a bipartite source side); every
    sender must index one of its rows.
    """

    @staticmethod
    def forward(ctx, x, w, indptr_r, col_r, indptr_s, col_s, eid_s):
        if x.shape[0] > indptr_s.numel() - 1:
            raise ValueError(f"x has {x.shape[0]} rows, the graph "
                             f"{indptr_s.numel() - 1} nodes")
        x = x.contiguous()
        w = None if w is None else w.contiguous()
        ctx.save_for_backward(x, w, indptr_s, col_s, eid_s)
        return spmm_csr(indptr_r, col_r, None, w, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, indptr_s, col_s, eid_s = ctx.saved_tensors
        dy = dy.contiguous()
        # senders index x's rows, so the CSR rows past them hold no edges
        ip = indptr_s[: x.shape[0] + 1]
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_w:
            dx, dw = spmm_sddmm(ip, col_s, eid_s, w, dy, x)
            dx = dx if need_x else None
        elif need_x:
            dx = spmm_csr(ip, col_s, eid_s, w, dy)
        return dx, dw, None, None, None, None, None


def spmm(g, x, *, edge_weight=None, weighted: bool = False):
    """``propagate(copy_xj | w_mul_xj | e_mul_xj, g, "sum")`` on the kernels.

    ``edge_weight`` (one per edge, in the graph's edge order) or, with
    ``weighted=True``, the graph's own ``edge_weight`` scales each message;
    with neither the product is unweighted.
    """
    w = None
    if edge_weight is not None or weighted:
        w = edge_weight if edge_weight is not None else g.edge_weight
    if w is not None:
        w = w.to(x.dtype)
    return SpmmFunction.apply(x, w, g.indptr_r, g.col_r, g.indptr_s,
                              g.col_s, g.eid_s)
