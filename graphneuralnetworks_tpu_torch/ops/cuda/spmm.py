"""CSR SpMM on the card: kernels K1 and K2, their plain versions, autograd.

Counterpart of ``graphneuralnetworks_tpu/ops/pallas/spmm.py``. The TPU
kernels scatter through one-hot matmuls over 128x512 receiver blocks; here
the graph carries two CSR groupings (``graph.py``) and the kernels walk
their rows (``csrc/spmm.cu``):

- K1 ``spmm_csr``: ``y[i] = sum_k w[eid[k]] * x[col[k]]`` over row ``i``.
  Over the receiver CSR it is the forward SpMM; over the sender CSR it is
  the backward for ``x``. Wide rows split into strips whose slice of the
  gathered table the L2 holds; a warp takes several rows of one strip, and
  each edge group issues several gathers before it adds them
  (:func:`_spmm_layout`).
- K2 ``spmm_sddmm``: over the sender CSR, ``dx[s] = sum w_e * dy[r_e]`` and
  ``dw_e = <dy[r_e], x[s]>`` in one sweep: the weighted backward, every
  head of rows of ``[., H, D]`` in one launch. K1's walk, strips and rows
  per warp (:func:`_spmm_sddmm_layout`); the dots of several strips or
  heads go through scratch by sender-CSR position, and a pass after the
  sweep adds them and writes them by edge id. bfloat16 rows have a
  chooser of their own (:func:`_spmm_sddmm_bf16_layout`): a head of up to
  256 bytes is one strip, and four heads that together fit it take one
  walk that reads and writes each edge's weights and dots at once.

Both take float32 or bfloat16 operands of one type (K1's ``x``, ``w`` and
``y``; K2's ``dy``, ``x``, ``w``, ``dx`` and ``dw``): bfloat16 rows are
loaded 8, 4 or 1 to a vector, summed in float32 and each output rounded
once (``csrc/vec.cuh``), as the TPU kernels sum each block with an f32 dot.
K2's scratch of per-strip dots stays float32. The plain versions take
bfloat16 the same way: computed in float32 from the bfloat16 values,
rounded once at the end.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``spmm_plain`` / ``spmm_sddmm_plain``); a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches, and nothing else adds to it
(``k1_bf16``, ``k2_bf16``: the bfloat16 variants).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from .build import load

__all__ = ["launches", "spmm_csr", "spmm_sddmm", "spmm_plain",
           "spmm_sddmm_plain", "SpmmFunction", "spmm"]

launches = {"k1": 0, "k2": 0, "k1_bf16": 0, "k2_bf16": 0}
# K2's last launch of each dtype: its layout and the strips of a head, so
# that a caller can see which path of the chooser ran
last_layout = {"k2": None, "k2_bf16": None}

_INT32_MAX = 2**31 - 1

# K1's layout (csrc/spmm.cu), from chip_smoke.py --sweep, which times
# every choice (PERF.md §6): the bytes of the table slice one strip
# may gather from (the L2 keeps a 16 MB slice: strips of 8 float4 beat
# whole rows by ~30 % at D = 128; a strip is at least one 128-byte line),
# the index windows a row's lanes take on average (fixes the rows per warp,
# :func:`_windowed_rows`), and the gathers an edge group issues before it
# adds them with the register cap (0: none), for groups of fewer than 128
# bytes and for the others. K2 takes K1's strips and rows per warp (two
# strips of 256 bytes beat four of 128 by 4 % at D = 128 on the uniform
# graph and lost by a quarter on R-MAT, where a hub's warp walks each
# strip: PERF.md §6), (gathers in flight, register cap) of its own, and
# reads its weights and writes its dots by sender-CSR position
# (csrc/spmm.cu) for several heads; one head takes them by edge id (0.8 %
# faster at D = 128, a third at D = 8).
_K1_STRIP_BYTES = 16 * 2**20
_K1_LINE_BYTES = 128
_K1_WINDOWS_PER_ROW = 2
_K1_NARROW = (2, 0)
_K1_WIDE = (8, 64)
_K2_NARROW = (2, 0)
_K2_WIDE = (4, 64)
# bfloat16 K2 has a chooser of its own, from chip_smoke.py --sweep bf16_k2
# (PERF.md §6). On bf16x8 rows a head of at most _K2_BF16_ROW_BYTES bytes
# is one whole-row strip whatever its table's size (at D = 128 a 32 MiB
# dy table that float32's 16 MiB strip line cut in two: dy gathered twice,
# each edge's two partial dots through float32 scratch and a third
# launch), and four heads that together fit it take the all-heads walk
# (csrc/spmm.cu spmm_sddmm_heads_kernel: GAT (b)'s H = 4, D = 32; no
# weight pass, scratch or sum pass). _K2_BF16 gives, by the bytes
# of one head's row, its (gathers in flight, register cap, index windows
# a row), and _K2_BF16_WALK the all-heads walk's. Other bfloat16 rows take
# float32's rule, in bytes.
_K2_BF16_ROW_BYTES = 256
_K2_BF16 = ((16, (1, 64, 2)), (256, (4, 64, 2)))
_K2_BF16_WALK = (2, 64, 2)


@functools.cache
def _lib(sweep: bool = False) -> ctypes.CDLL:
    lib = load("spmm", sweep=sweep)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in ("spmm_csr_f32", "spmm_csr_bf16"):
        getattr(lib, fn).argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
        getattr(lib, fn).restype = i32
    for fn in ("spmm_sddmm_csr_f32", "spmm_sddmm_csr_bf16"):
        getattr(lib, fn).argtypes = [ptr] * 9 + [i32] * 10 + [ptr]
        getattr(lib, fn).restype = i32
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


def _float4_rows(d: int, *rows) -> bool:
    """Whether the kernels load rows of ``d`` floats as float4: ``d % 4 ==
    0`` and every row operand 16-byte aligned."""
    return _row_vectors(d, 4, *rows)[1] == 16


def _row_vectors(d: int, elem: int, *rows) -> tuple[int, int]:
    """``(vectors, vector bytes)`` in which the kernels load rows of ``d``
    elements of ``elem`` bytes: float32 rows as float4 (16 bytes) where
    ``d % 4 == 0`` and every row operand (None ones aside) is 16-byte
    aligned, else one float; bfloat16 rows (``elem == 2``) as 8 values (16
    bytes, ``d % 8 == 0``, 16-byte aligned), else 4 (8 bytes, ``d % 4 ==
    0``, 8-byte aligned), else one (``csrc/vec.cuh``: bf16_vec_bytes)."""
    for vec in (16, 8) if elem == 2 else (16,):
        per = vec // elem
        if d % per == 0 and all(t is None or t.data_ptr() % vec == 0
                                for t in rows):
            return d // per, vec
    return d, elem


def _windowed_rows(log_group: int, n_rows: int, entries: int,
                   windows: float) -> int:
    """log2 of the CSR rows one warp of K1 or K8 takes: each row owns the
    power of two of lanes nearest ``entries / n_rows / windows`` (so that
    it walks its edges in about ``windows`` windows of one index per lane,
    the next loaded while the current one's rows are gathered), at least
    the ``2^log_group`` lanes of one edge group and at most the warp's 32.
    At N = 131,072, E = 2M (15.3 edges a row) that is 8 lanes: 4 rows per
    warp at D = 8 (4 groups of 2 lanes a row) and at D = 7 (one group of 8
    lanes), the fastest layouts of the sweep."""
    mean = entries / n_rows if n_rows else 0.0
    log_seg = round(math.log2(mean / windows)) if mean > windows else 0
    return 5 - min(5, max(log_group, log_seg))


def _strip_rows(fv: int, vec_bytes: int, table_rows: int, n_rows: int,
                entries: int) -> tuple[int, int]:
    """K1's and K2's ``(log_rows, log_strip)`` for rows of ``fv`` vectors of
    ``vec_bytes`` (:func:`_row_vectors`: 16, 8, 4 or 2) gathered from a
    table of
    ``table_rows`` rows, over ``n_rows`` output rows of ``entries / n_rows``
    edges on average.

    Strip: the row's whole ``G`` vectors when the table fits in
    ``_K1_STRIP_BYTES``, else the widest power of two of vectors, down to
    one ``_K1_LINE_BYTES`` line, whose slice of the table fits; whole rows
    again when not even that fits (nothing for the L2 to keep). Rows per
    warp: :func:`_windowed_rows` for groups of one strip."""
    log_g = min((fv - 1).bit_length(), 5)
    log_line = max(0, (_K1_LINE_BYTES // vec_bytes - 1).bit_length())
    log_strip = log_g
    while (log_strip > log_line
           and table_rows * vec_bytes << log_strip > _K1_STRIP_BYTES):
        log_strip -= 1
    if table_rows * vec_bytes << log_strip > _K1_STRIP_BYTES:
        log_strip = log_g
    return (_windowed_rows(log_strip, n_rows, entries, _K1_WINDOWS_PER_ROW),
            log_strip)


def _spmm_layout(fv: int, vec_bytes: int, table_rows: int, n_rows: int,
                 entries: int) -> tuple[int, int, int, int]:
    """K1's ``(log_rows, log_strip, unroll, reg_cap)``: :func:`_strip_rows`,
    and ``_K1_WIDE`` (unroll, reg_cap) for groups of a line or more, else
    ``_K1_NARROW``."""
    log_rows, log_strip = _strip_rows(fv, vec_bytes, table_rows, n_rows,
                                      entries)
    wide = vec_bytes << log_strip >= _K1_LINE_BYTES
    return (log_rows, log_strip) + (_K1_WIDE if wide else _K1_NARROW)


def _spmm_sddmm_layout(fv: int, vec_bytes: int, table_rows: int,
                       n_rows: int, entries: int, heads: int = 1
                       ) -> tuple[int, int, int, int, int]:
    """float32 K2's ``(log_rows, log_strip, unroll, reg_cap, mode)`` for
    ``heads`` heads of ``fv`` vectors gathered from ``table_rows`` rows of
    ``dy``: K1's strip and rows per warp (:func:`_strip_rows`; heads run
    one after the other, so one head's slice is the table), ``_K2_WIDE``
    (unroll, reg_cap) for groups of a line or more, else ``_K2_NARROW``;
    mode 1 (the weights and dots by sender-CSR position) for more than one
    head, else 0 (by edge id)."""
    log_rows, log_strip = _strip_rows(fv, vec_bytes, table_rows, n_rows,
                                      entries)
    wide = vec_bytes << log_strip >= _K1_LINE_BYTES
    return ((log_rows, log_strip) + (_K2_WIDE if wide else _K2_NARROW)
            + (int(heads > 1),))


def _spmm_sddmm_bf16_layout(fv: int, vec_bytes: int, table_rows: int,
                            n_rows: int, entries: int, heads: int = 1,
                            heads_ok: bool = True
                            ) -> tuple[int, int, int, int, int]:
    """bfloat16 K2's layout (as :func:`_spmm_sddmm_layout`'s): on bf16x8
    rows (``vec_bytes`` 16), four heads of a power of two of vectors that
    together fit ``_K2_BF16_ROW_BYTES`` take the all-heads walk (mode 2,
    one group of their lanes, where ``heads_ok``: the weights' rows are
    aligned to load an edge's heads at once) at ``_K2_BF16_WALK``, one
    head that fits it one whole-row strip (mode 0) at ``_K2_BF16``'s entry
    for its bytes; other rows float32's rule."""
    group = fv * heads
    if vec_bytes == 16 and group * vec_bytes <= _K2_BF16_ROW_BYTES:
        pow2 = fv & (fv - 1) == 0
        if heads == 1 or (heads == 4 and pow2 and heads_ok):
            log_g = (group - 1).bit_length()
            unroll, cap, windows = (_K2_BF16_WALK if heads > 1 else next(
                e for most, e in _K2_BF16 if group * vec_bytes <= most))
            return (_windowed_rows(log_g, n_rows, entries, windows), log_g,
                    unroll, cap, 0 if heads == 1 else 2)
    return _spmm_sddmm_layout(fv, vec_bytes, table_rows, n_rows, entries,
                              heads)


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
    """K1's operands: rows ``dense`` and weights ``w`` of one float type,
    float32 or bfloat16 (a mix raises ``TypeError``), int32 CSR, all
    contiguous on one device."""
    device, dtype = dense[0].device, dense[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K1 kernel takes float32 or bfloat16 rows, got "
                        f"{dtype}")
    for i, t in enumerate(dense):
        _check(t, f"dense operand {i}", dtype, device)
        if t.dim() != 2:
            raise ValueError(f"dense operand {i} must be 2-D, got "
                             f"{tuple(t.shape)}")
    for name, t in (("indptr", indptr), ("col", col), ("eid", eid)):
        _check(t, name, torch.int32, device)
    _check(w, "w", dtype, device)
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


def _entries(indptr: torch.Tensor) -> int:
    """The positions a CSR fills, ``indptr[-1]``: all of them but in a
    compacted view (``graph.csr_view``), which keeps its arrays at the
    graph's edge count and fills the first ``indptr[-1]``. The plain
    versions read (and write) no further, as the kernels do."""
    return int(indptr[-1])


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions (and the kernels) compute a ``dtype``
    input in: float32 for bfloat16 and float16, else ``dtype`` itself."""
    return (torch.float32 if dtype in (torch.bfloat16, torch.float16)
            else dtype)


def spmm_plain(indptr, col, eid, w, x):
    """``y[i] = sum_{k in [indptr[i], indptr[i+1])} w[eid[k]] * x[col[k]]``.

    ``col=None`` reads ``x[k]`` (rows already in grouping order),
    ``eid=None`` reads ``w[k]``, ``w=None`` is unweighted. A bfloat16 ``x``
    (and ``w``) is summed in float32 and ``y`` rounded once to bfloat16.
    """
    n = _entries(indptr)
    rows = _row_ids(indptr, n)
    work = _work_dtype(x.dtype)
    src = x[:n] if col is None else x.index_select(0, col[:n].long())
    src = src.to(work)
    if w is not None:
        we = w[:n] if eid is None else w.index_select(0, eid[:n].long())
        src = src * we.to(work).unsqueeze(-1)
    out = src.new_zeros((indptr.numel() - 1, x.shape[1]))
    return out.index_add_(0, rows, src).to(x.dtype)


def spmm_sddmm_plain(indptr, col, eid, w, dy, x):
    """Over a sender CSR: ``(dx, dw)`` with ``dx[s] = sum w_e dy[col_e]`` and
    ``dw[eid_e] = <dy[col_e], x[s]>`` (unweighted). ``dx`` has ``x``'s rows.
    Rows of ``[., H, D]`` take it per head, with ``w`` and ``dw`` ``[E,
    H]``; rows of ``[., D]`` with ``[E]``. A compacted view's edges
    outside it get ``dw`` 0.
    """
    n = _entries(indptr)
    rows = _row_ids(indptr, n)
    work = _work_dtype(x.dtype)
    dyv = dy.index_select(0, col[:n].long()).to(work)
    ids = (eid[:n].long() if eid is not None
           else torch.arange(n, device=dy.device))
    scaled = dyv if w is None else dyv * w.index_select(0, ids).to(
        work).unsqueeze(-1)
    dx = dyv.new_zeros(x.shape).index_add_(0, rows, scaled)
    dots = (dyv * x.index_select(0, rows).to(work)).sum(-1)
    dw = dots.new_zeros((col.numel(),) + dots.shape[1:]).index_copy_(
        0, ids, dots)
    return dx.to(x.dtype), dw.to(x.dtype if w is None else w.dtype)


# ---- kernel wrappers -------------------------------------------------------

def _spmm_csr_kernel(indptr, col, eid, w, x, layout=None):
    """K1 at :func:`_spmm_layout`'s layout, or at ``layout`` (``(log_rows,
    log_strip, unroll, reg_cap)``) from the sweep build of the library,
    which holds every (unroll, reg_cap) instance (``build.load``)."""
    _check_launch(indptr, col, eid, w, x)
    n_rows, d = indptr.numel() - 1, x.shape[1]
    y = torch.empty((n_rows, d), dtype=x.dtype, device=x.device)
    if n_rows == 0 or d == 0:
        return y
    fv, vec_bytes = _row_vectors(d, x.element_size(), x, y)
    bf16 = x.dtype == torch.bfloat16
    lib = _lib(sweep=layout is not None)
    if layout is None:
        n_edges = col.numel() if col is not None else x.shape[0]
        layout = _spmm_layout(fv, vec_bytes, x.shape[0], n_rows, n_edges)
    fn = "spmm_csr_bf16" if bf16 else "spmm_csr_f32"
    code = _call_on(x.device, getattr(lib, fn), _ptr(indptr), _ptr(col),
                    _ptr(eid), _ptr(w), _ptr(x), _ptr(y), n_rows, d,
                    vec_bytes, *layout)
    launches["k1_bf16" if bf16 else "k1"] += 1
    _raise_on_error(lib, code, fn)
    return y


def _check_sddmm(indptr, col, eid, w, dy, x) -> int:
    """K2's operands: rows ``dy``, ``x`` of one shape past the first
    dimension, ``[., D]`` or ``[., H, D]``; ``w`` ``[E]`` or ``[E, H]`` to
    match, or None; ``dy``, ``x`` and ``w`` of one float type, float32 or
    bfloat16 (a mix raises ``TypeError``); int32 CSR; all contiguous on one
    device. Returns H."""
    device, dtype = x.device, x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K2 kernel takes float32 or bfloat16 rows, got "
                        f"{dtype}")
    if x.dim() not in (2, 3) or dy.shape[1:] != x.shape[1:]:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} must "
                         "be [rows, D] or [rows, H, D] alike")
    for name, t in (("dy", dy), ("x", x), ("w", w)):
        _check(t, name, dtype, device)
    for name, t in (("indptr", indptr), ("col", col), ("eid", eid)):
        _check(t, name, torch.int32, device)
    if w is not None and w.shape != (col.numel(),) + x.shape[1:-1]:
        raise ValueError(f"w must be {(col.numel(),) + x.shape[1:-1]}, got "
                         f"{tuple(w.shape)}")
    if col.numel() > _INT32_MAX:
        raise ValueError("the CUDA kernels index edges with int32: at most "
                         f"{_INT32_MAX} edges")
    return 1 if x.dim() == 2 else x.shape[1]


def _spmm_sddmm_kernel(indptr, col, eid, w, dy, x, layout=None):
    """K2 at :func:`_spmm_sddmm_layout`'s layout (bfloat16:
    :func:`_spmm_sddmm_bf16_layout`'s), or at ``layout``
    (``(log_rows, log_strip, unroll, reg_cap, mode)``) from the sweep build
    of the library, which holds every (unroll, reg_cap) instance
    (``build.load``). Scratch (float32): by position (mode 1), ``H * strips
    * E`` floats for the dots of every strip and ``H * E`` for the weights
    (the bfloat16 ones take half of it); by edge id (mode 0) the dots' where
    a head spans several strips; none for the all-heads walk (mode 2).
    bfloat16 rows take ``spmm_sddmm_csr_bf16``: ``dx`` and ``dw`` in
    bfloat16, each rounded once from its float32 sum."""
    heads = _check_sddmm(indptr, col, eid, w, dy, x)
    n_rows, d, n_edges = indptr.numel() - 1, x.shape[-1], col.numel()
    if x.shape[0] != n_rows:
        raise ValueError(f"x {tuple(x.shape)} does not match a sender CSR "
                         f"of {n_rows} rows")
    dx = torch.empty_like(x)
    dw = torch.empty((n_edges,) + x.shape[1:-1], dtype=x.dtype,
                     device=x.device)
    if n_rows == 0 or n_edges == 0 or heads == 0:
        return dx.zero_(), dw
    if d == 0:
        return dx, dw.zero_()
    bf16 = x.dtype == torch.bfloat16
    fv, vec_bytes = _row_vectors(d, x.element_size(), dy, x, dx)
    lib = _lib(sweep=layout is not None)
    if layout is None and bf16:
        heads_ok = w is None or w.data_ptr() % (2 * heads) == 0
        layout = _spmm_sddmm_bf16_layout(fv, vec_bytes, dy.shape[0], n_rows,
                                         n_edges, heads, heads_ok)
    elif layout is None:
        layout = _spmm_sddmm_layout(fv, vec_bytes, dy.shape[0], n_rows,
                                    n_edges, heads)
    strips = -(-fv >> layout[1])
    mode = layout[4]
    parts = (strips + (w is not None) if mode == 1 else
             strips if mode == 0 and strips > 1 else 0)
    scratch = (torch.empty(heads * parts * n_edges, dtype=torch.float32,
                           device=x.device) if parts else None)
    fn = "spmm_sddmm_csr_bf16" if bf16 else "spmm_sddmm_csr_f32"
    code = _call_on(x.device, getattr(lib, fn), _ptr(indptr), _ptr(col),
                    _ptr(eid), _ptr(w), _ptr(dy), _ptr(x), _ptr(dx),
                    _ptr(dw), _ptr(scratch), n_rows, heads, d, n_edges,
                    vec_bytes, *layout)
    launches["k2_bf16" if bf16 else "k2"] += 1
    last_layout["k2_bf16" if bf16 else "k2"] = (layout, strips)
    _raise_on_error(lib, code, fn)
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
    """K2 on CUDA tensors, :func:`spmm_sddmm_plain` on CPU tensors: ``(dx,
    dw)`` over a sender CSR, for rows ``dy``, ``x`` of ``[., D]`` (``w``,
    ``dw``: ``[E]``) or ``[., H, D]`` (``[E, H]``, every head in one
    launch). Both take bfloat16 as :func:`spmm_plain` does."""
    if _route(x) == "cpu":
        return spmm_sddmm_plain(indptr, col, eid, w, dy, x)
    return _spmm_sddmm_kernel(indptr, col, eid, w, dy, x)


class SpmmFunction(torch.autograd.Function):
    """``y[i] = sum_{e: r_e = i} w_e * x[s_e]`` with a kernel backward.

    Forward: K1 over the receiver CSR, reading ``w`` through ``eid_r`` (a
    reversed graph's; None: CSR positions are edge ids). Backward: K2 over
    the sender CSR when ``w`` needs a gradient, else K1 over the sender
    CSR. ``x`` may have fewer rows than the graph has nodes (a bipartite
    source side); every sender must index one of its rows.
    """

    @staticmethod
    def forward(ctx, x, w, indptr_r, col_r, indptr_s, col_s, eid_s,
                eid_r=None):
        if x.shape[0] > indptr_s.numel() - 1:
            raise ValueError(f"x has {x.shape[0]} rows, the graph "
                             f"{indptr_s.numel() - 1} nodes")
        x = x.contiguous()
        w = None if w is None else w.contiguous()
        ctx.save_for_backward(x, w, indptr_s, col_s, eid_s)
        return spmm_csr(indptr_r, col_r, eid_r, w, x)

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
        return dx, dw, None, None, None, None, None, None


def spmm(g, x, *, edge_weight=None, weighted: bool = False):
    """``propagate(copy_xj | w_mul_xj | e_mul_xj, g, "sum")`` on the kernels.

    ``edge_weight`` (one per edge, in the graph's edge order) or, with
    ``weighted=True``, the graph's own ``edge_weight`` scales each message;
    with neither the product is unweighted. On a graph with ``edge_valid``
    an invalid edge weighs 0 (JAX folds ``edge_mask`` into the weights the
    same way), so K1 runs weighted; the 0/1 weights need no gradient.
    """
    w = None
    if edge_weight is not None or weighted:
        w = edge_weight if edge_weight is not None else g.edge_weight
    if g.edge_valid is not None:
        w = (g.edge_valid.to(x.dtype) if w is None
             else torch.where(g.edge_valid, w, torch.zeros_like(w)))
    if w is not None:
        w = w.to(x.dtype)
    return SpmmFunction.apply(x, w, g.indptr_r, g.col_r, g.indptr_s,
                              g.col_s, g.eid_s, g.eid_r)
