"""bfloat16 K6, K7 and K8's layouts of their own: ``_dot_recv_layout``
and ``_dot_bwd_rev_layout`` by vector width (``ops/cuda/edge_softmax.py``'s
``_K6_BF16``, ``_K7_BF16``, ``_K8_BF16``, ``_DOT_BF16_ROWS_BYTES``, K6's
and K7's one strips rule), every layout they return one the shipped
library builds (``csrc/edge_softmax.cu``'s picks, read from the source),
and the wrappers' launches: the layout, the strips' scratch and K8's
receiver scalars packed as one float4, through a stand-in library that
runs the plain versions on CPU tensors (the kernels have no CPU mode;
``tests/test_torch_kernels.py`` and ``tests/test_torch_spmm_layouts.py``
hold them to the plain versions on the card).

This file imports no JAX.
"""

import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402

SOURCE = (Path(ES.__file__).resolve().parents[2] / "csrc"
          / "edge_softmax.cu").read_text()
MEAN_ROW_LENGTHS = [0, 0.5, 1, 3, 15.26, 100, 2048]
N, E = 131_072, 2_000_000
# the register instances the shipped library holds at one register chunk
# (K8Pick; RecvPick, which K6's rows take) and wider (both: one edge,
# uncapped); the strips' (StripPick)
K8_REGISTER = ((2, 64),)
RECV_REGISTER = ((2, 64), (4, 64))
WIDE_REGISTER = ((1, 0),)
STRIP = (4, 0)
# the staged K8's instance past one register chunk (with_staged_instances)
WIDE_STAGED = (1, 2, 0)


def _pick_body(name):
    return re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)


# (edges a stage, stages, register cap) of each staged K8 instance the
# shipped library holds at one register chunk (K8StagedPick), and the
# (edges in flight, register cap) K6Bf16Pick adds to RecvPick's for
# bf16x8 rows of one register chunk
K8_STAGED = {tuple(int(x) for x in m) for m in re.findall(
    r"u == (\d+) && ns == (\d+) && cap == (\d+)", _pick_body("K8StagedPick"))}
K6_BF16_REGISTER = RECV_REGISTER + tuple(
    tuple(int(x) for x in m) for m in re.findall(
        r"nc == 1 && u == (\d+) && cap == (\d+)", _pick_body("K6Bf16Pick")))
# bfloat16 K7's register pairs on bf16x8 rows of one register chunk
# (K7Bf16Pick's ``nc == 1 ? (u == U || u == U') && cap == C``), and the
# most register chunks its wider rows take
_K7_ONE = re.search(r"nc == 1 \? \(u == (\d+) \|\| u == (\d+)\) && "
                    r"cap == (\d+)", _pick_body("K7Bf16Pick")).groups()
K7_BF16_REGISTER = tuple((int(u), int(_K7_ONE[2])) for u in _K7_ONE[:2])
K7_BF16_CHUNKS = int(re.search(r"nc <= (\d+)",
                               _pick_body("K7Bf16Pick")).group(1))


def _log_g(vectors):
    return min((vectors - 1).bit_length(), 5)


def _widths():
    """``(o, d, widest vector bytes, ov, dv)`` for bfloat16 heads of 1 to
    300 values a side (and O != D), in each vector they may take."""
    for o in list(range(1, 301)) + [512, 1024, 2048]:
        for d in sorted({o, 8, 13, 32, 128}):
            for vec in (16, 8, 2):
                per = vec // 2
                if o % per == 0 and d % per == 0 and max(o, d) // per <= 256:
                    yield o, d, vec, o // per, d // per


def test_picks_read_from_the_source():
    """The picks the tests below read from the source name at least one
    instance each: staged K8 with at least two stages, K6's extra bf16x8
    register pair, and K7's two bf16x8 pairs of one register chunk and its
    most chunks (as ``_K7_BF16_MAX_ROWS``)."""
    assert K8_STAGED and all(ns >= 2 and cap in (0, 64)
                             for _, ns, cap in K8_STAGED)
    assert len(K6_BF16_REGISTER) > len(RECV_REGISTER)
    assert len(K7_BF16_REGISTER) == 2
    assert K7_BF16_CHUNKS * 32 == ES._K7_BF16_MAX_ROWS


def _check_k8(lay, vec, ov, dv):
    log_rows, unroll, cap, stages = lay
    wide = max(ov, dv, 1)
    assert 0 <= log_rows <= 5 - _log_g(wide)
    if stages:
        assert vec == 16
        assert ((unroll, stages, cap) in K8_STAGED if wide <= 32
                else (unroll, stages, cap) == WIDE_STAGED)
    else:
        # no register instance of bf16x8 vectors is shipped
        assert vec < 16
        assert (unroll, cap) in (K8_REGISTER if wide <= 32
                                 else WIDE_REGISTER)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (N, m) for m in MEAN_ROW_LENGTHS])
def test_k8_bf16_layouts_are_built(n_rows, mean):
    """bfloat16 K8's chooser gives, for every width and vector and at each
    mean row length (an empty graph too), a layout of the shipped library:
    on bf16x8 rows a staged instance of its pick (past 32 vectors a row,
    the wide instance), on 8-byte vectors or single values the register
    kernel at K8Pick's pairs; R rows of G lanes fit a warp."""
    entries = round(mean * n_rows)
    for o, d, vec, ov, dv in _widths():
        lay = ES._dot_bwd_rev_layout(ov, dv, n_rows, entries, vec, 2)
        _check_k8(lay, vec, ov, dv)


def _check_recv(lay, vec, ov, dv, register, chunks=8):
    """A bfloat16 K6 or K7 layout ``(strips, log_rows, unroll, reg_cap)``
    is one the shipped library builds: strips at StripPick's pair (a line's
    vectors a group), register rows at ``register``'s pairs on bf16x8 rows
    (in at most ``chunks`` register chunks) and RecvPick's on narrower
    vectors."""
    strips, log_rows, unroll, cap = lay
    wide = max(ov, dv, 1)
    if strips:
        line = min(128 // vec, 32)
        assert wide > line
        assert (unroll, cap) == STRIP
        assert 0 <= log_rows <= 5 - _log_g(line)
        return
    assert 0 <= log_rows <= 5 - _log_g(wide)
    pairs = register if vec == 16 else RECV_REGISTER
    assert (unroll, cap) in (pairs if wide <= 32 else WIDE_REGISTER)
    assert vec < 16 or wide <= 32 * chunks


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (N, m) for m in MEAN_ROW_LENGTHS])
def test_k6_bf16_layouts_are_built(n_rows, mean):
    """bfloat16 K6's chooser, as K8's: strips at StripPick's pair (a line's
    vectors a group), register rows at K6Bf16Pick's pairs on bf16x8 rows
    and RecvPick's on narrower vectors; K7 takes the strips where K6 does
    (one rule: they gather the same k and v tables), and for bf16x8 heads
    of more than ``_K7_BF16_MAX_ROWS`` vectors."""
    entries = round(mean * n_rows)
    for n_src in (n_rows, 4096, 2_000_000):
        for o, d, vec, ov, dv in _widths():
            lay = ES._dot_recv_layout(ov, dv, vec, n_src, n_rows, entries, 2)
            _check_recv(lay, vec, ov, dv, K6_BF16_REGISTER)
            k7 = ES._dot_recv_layout(ov, dv, vec, n_src, n_rows, entries, 2, 7)
            assert lay[0] == ES._dot_bf16_strips(ov, dv, vec, n_src)
            assert k7[0] == (lay[0] or (
                vec == 16 and max(ov, dv) > ES._K7_BF16_MAX_ROWS))


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (N, m) for m in MEAN_ROW_LENGTHS])
def test_k7_bf16_layouts_are_built(n_rows, mean):
    """bfloat16 K7's chooser: strips at StripPick's pair, register rows
    at K7Bf16Pick's pairs on bf16x8 rows of at most its register chunks
    (RecvPick's on narrower vectors); R rows of G lanes fit a warp."""
    entries = round(mean * n_rows)
    for n_src in (n_rows, 4096, 2_000_000):
        for o, d, vec, ov, dv in _widths():
            lay = ES._dot_recv_layout(ov, dv, vec, n_src, n_rows, entries, 2,
                                      7)
            _check_recv(lay, vec, ov, dv, K7_BF16_REGISTER, K7_BF16_CHUNKS)


def test_k7_bf16_table_is_built():
    """Each entry of ``_K7_BF16`` names a register pair K7Bf16Pick holds
    at one register chunk."""
    for most, (unroll, cap, windows) in ES._K7_BF16:
        assert most <= 32 * 16 and windows > 0
        assert (unroll, cap) in K7_BF16_REGISTER


@pytest.mark.parametrize("o,d,want", [
    # Transformer layer 1 (H=4): 64-byte rows, 4 lanes of bf16x8, 2 edges
    # in flight at 64 registers, 4 rows a warp
    (32, 32, (0, 2, 2, 64)),
    # its head layer (H=1): 16-byte rows, one bf16x8 lane a group, one edge
    # in flight at 64 registers
    (8, 8, (0, 2, 1, 64)),
    # AGNN (H=1): 256-byte rows in rows on its 32 MiB tables, not strips
    (128, 128, (0, 1, 2, 64)),
    # two register chunks: strips (its 66 MiB table exceeds the line)
    (264, 264, (1, 2, 4, 0)),
    # nine chunks: strips at any table size
    (1032, 1032, (1, 2, 4, 0)),
])
def test_k7_bf16_layouts_at_the_measured_shapes(o, d, want):
    """At N = 131,072 senders and receivers, E = 2M, bfloat16 K7's layouts
    by its table (chip_smoke.py --sweep bf16_k7, PERF.md §6): AGNN's head
    in rows at any table size, the (1, 264, 264) head in strips, and heads
    of more than 4 register chunks in strips on a small table too."""
    ov, dv = o // 8, d // 8
    assert ES._dot_recv_layout(ov, dv, 16, N, N, E, 2, 7) == want
    assert ES._dot_recv_layout(ov, dv, 16, 64, N, E, 2, 7)[0] == (o > 1024)
    # AGNN's head on tables of 64 and 128 MiB: rows still
    assert ES._dot_recv_layout(16, 16, 16, 2 * N, N, E, 2, 7)[0] == 0
    assert ES._dot_recv_layout(16, 16, 16, 4 * N, N, E, 2, 7)[0] == 0


@pytest.mark.parametrize("ov,dv,n_src,want", [
    (8, 8, N, (0, 2, 4, 64)),       # Transformer (4, 32, 32) in float4
    (2, 2, N, (0, 2, 2, 64)),       # its head layer (1, 8, 8)
    (32, 32, N, (1, 2, 4, 0)),      # AGNN (1, 128, 128): strips
    (32, 32, 4096, (0, 0, 4, 64)),  # a 2 MB table: rows
    (64, 64, N, (1, 2, 4, 0)),      # (1, 256, 256): strips
])
def test_f32_k7_layouts_unchanged(ov, dv, n_src, want):
    """float32 K7 keeps float32's rule (K6's, four integers), at the shapes
    of PERF.md §6."""
    for kernel in (6, 7):
        assert ES._dot_recv_layout(ov, dv, 16, n_src, N, E, 4,
                                   kernel) == want


@pytest.mark.parametrize("o,d,vec,k6,k8", [
    # Transformer layer 1 (H=4): 64-byte rows, 4 lanes of bf16x8; K8
    # staged, 8 rows a warp; K6 the register kernel, 4 edges in flight
    (32, 32, 16, (0, 2, 4, 64), (3, 2, 0, 2)),
    # its head layer (H=1): 16-byte rows, one bf16x8 lane a group; K6 one
    # edge in flight, K8 staged
    (8, 8, 16, (0, 2, 1, 0), (2, 1, 0, 2)),
    # AGNN (H=1): 256-byte rows; K6 in rows (not strips), K8 staged
    (128, 128, 16, (0, 1, 4, 64), (1, 2, 0, 2)),
    # two register chunks of bf16x8: K8 staged, one edge a stage; K6 in
    # strips (wider than _DOT_BF16_ROWS_BYTES, its 66 MiB table exceeds
    # _DOT_STRIP_BYTES)
    (264, 264, 16, (1, 2, 4, 0), (0, 1, 0, 2)),
    # rows that take 8-byte vectors at most: the register kernel on them,
    # as float32 picks it
    (12, 12, 8, (0, 2, 2, 64), (2, 2, 64, 0)),
    # single values: the same
    (13, 13, 2, (0, 1, 2, 64), (1, 2, 64, 0)),
])
def test_bf16_dot_layouts_at_the_measured_shapes(o, d, vec, k6, k8):
    """At N = 131,072, E = 2M, the layouts the bfloat16 table gives by
    vector width (chip_smoke.py --sweep bf16, PERF.md §6)."""
    per = vec // 2
    ov, dv = o // per, d // per
    assert ES._dot_recv_layout(ov, dv, vec, N, N, E, 2) == k6
    assert ES._dot_bwd_rev_layout(ov, dv, N, E, vec, 2) == k8


@pytest.mark.parametrize("vec", [16, 8, 2])
def test_bf16_k6_strips_follow_the_rule(vec):
    """bfloat16 K6 and K7 keep bf16x8 heads of at most
    ``_DOT_BF16_ROWS_BYTES`` (AGNN's (1, 128, 128)) in rows on tables of
    any size; wider bf16x8 heads, and heads of narrower vectors, take the
    strips once wider than a line with a wider table of more than
    ``_DOT_STRIP_BYTES``, as float32's rule does."""
    line = ES._line_vectors(vec)
    narrow = ES._DOT_BF16_ROWS_BYTES // vec
    assert narrow > line
    for wide in (line + 1, narrow, narrow + 1, 2 * narrow):
        edge = ES._DOT_STRIP_BYTES // (wide * vec)
        for n_src in (edge, edge + 1, 1000 * edge):
            f32 = n_src * wide * vec > ES._DOT_STRIP_BYTES
            kept = vec == 16 and wide <= narrow
            for kernel in (6, 7):
                got = ES._dot_recv_layout(wide, wide, vec, n_src, N, E, 2,
                                          kernel)[0]
                assert got == (0 if kept else f32)
    # AGNN's table of 128 MiB and more: rows
    for kernel in (6, 7):
        assert ES._dot_recv_layout(16, 16, 16, 1 << 23, N, E, 2,
                                   kernel)[0] == 0


# ---- the wrappers' launches, through a stand-in library -------------------

def _csr(rng, n_rows, n_cols):
    counts = rng.integers(0, 30, n_rows)
    counts[::7] = 0
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    col = torch.tensor(rng.integers(0, n_cols, int(indptr[-1])),
                       dtype=torch.int32)
    return indptr, col


class _PlainLib:
    """Stands in for the kernel library on CPU tensors (``_ptr`` passes
    the tensors themselves): checks each call's layout integers as the
    library does and computes the plain version into the outputs it was
    given, K8's receiver scalars read from the packed ``stats`` where its
    layout is staged."""

    def __init__(self):
        self.calls = []

    def dot_bwd_rev_bf16(self, indptr, col, q, k, v, mx, den, s_n, stats, dy,
                         dk, dv, n_rows, heads, o, d, log_rows, unroll,
                         reg_cap, stages, scale, slope, stream):
        self.calls.append(("k8", (log_rows, unroll, reg_cap, stages), stats))
        if stages:
            # the staged kernel takes bf16x8 rows only
            assert o % 8 == 0 and d % 8 == 0 and stats.dtype == torch.float32
            assert stats.shape == mx.shape + (4,) and stats.is_contiguous()
            mx, den, s_n = stats[..., 0], stats[..., 1], stats[..., 2]
        else:
            assert stats is None
        a, b = ES.dot_bwd_rev_plain(indptr, col, q, k, v, mx, den, s_n, dy,
                                    scale, slope)
        dk.copy_(a)
        dv.copy_(b)
        return 0

    def dot_bwd_dq_bf16(self, indptr, col, q, k, v, mx, den, s_n, dy, raw,
                        dq, scratch, n_rows, heads, o, d, n_edges, strips,
                        log_rows, unroll, reg_cap, scale, slope, stream):
        self.calls.append(("k7", (strips, log_rows, unroll, reg_cap),
                           scratch))
        dq.copy_(ES.dot_bwd_dq_plain(indptr, col, q, k, v, mx, den, s_n, dy,
                                     scale, None if slope == 1.0 else slope,
                                     raw))
        return 0

    def dot_softmax_bf16(self, indptr, col, q, k, v, num, m, s, raw, scratch,
                         n_rows, heads, o, d, n_edges, strips, log_rows,
                         unroll, reg_cap, scale, slope, stream):
        self.calls.append(("k6", (strips, log_rows, unroll, reg_cap),
                           scratch))
        a, b, c = ES.dot_softmax_plain(indptr, col, q, k, v, scale, slope,
                                       raw)
        num.copy_(a)
        m.copy_(b)
        s.copy_(c)
        return 0


@pytest.fixture
def plain_lib(monkeypatch):
    lib = _PlainLib()
    monkeypatch.setattr(ES, "_lib", lambda sweep=False: lib)
    monkeypatch.setattr(ES, "_ptr", lambda t: t)
    monkeypatch.setattr(ES, "_call_on", lambda device, fn, *a: fn(*a, None))
    return lib


def _dot_inputs(heads, o, d, seed):
    rng = np.random.default_rng(seed)
    indptr, col = _csr(rng, 40, 50)

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).bfloat16()

    q, dy = bf(50, heads, o), bf(50, heads, d)
    k, v = bf(40, heads, o), bf(40, heads, d)
    mx = torch.tensor(rng.standard_normal((50, heads)), dtype=torch.float32)
    den = torch.tensor(rng.uniform(1, 3, (50, heads)), dtype=torch.float32)
    s_n = torch.tensor(rng.standard_normal((50, heads)), dtype=torch.float32)
    return indptr, col, q, k, v, mx, den, s_n, dy


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (2, 4, 12),
                                       (1, 128, 128), (1, 13, 13)])
@pytest.mark.parametrize("slope", [None, 0.2])
def test_packed_k8_route_gives_the_unpacked_answers(plain_lib, heads, o, d,
                                                    slope):
    """``_dot_bwd_rev_kernel`` on bfloat16 CPU tensors, through its checks,
    its layout and the packing of the receivers' ``(mx, den, s_n)`` into
    ``[rows, H, 4]`` float32 (staged layouts; none for the register
    kernel), at the chooser's layout, at a staged layout where the rows
    take bf16x8 and at a register one: the same bits as the plain version
    on the unpacked scalars."""
    indptr, col, q, k, v, mx, den, s_n, dy = _dot_inputs(heads, o, d,
                                                         heads + o + d)
    args = (indptr, col, q, k, v, mx, den, s_n, dy, o ** -0.5, slope)
    want = ES.dot_bwd_rev_plain(*args)
    ov, dv, vec = ES._dot_vectors(o, d, q, k, v, dy)
    layouts = [None] + [(0, 1, 64, 4)] * (vec == 16) + [(0, 2, 64, 0)]
    before = ES.launches["k8_bf16"]
    for lay in layouts:
        got = ES._dot_bwd_rev_kernel(*args, layout=lay)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, b)
    chosen = ES._dot_bwd_rev_layout(ov, dv, 40, col.numel(), vec, 2)
    assert plain_lib.calls[0][1] == chosen
    assert bool(chosen[3]) == (vec == 16)
    for _, lay, stats in plain_lib.calls:
        assert (stats is not None) == bool(lay[3])
        if stats is not None:
            assert torch.equal(stats[..., :3],
                               torch.stack((mx, den, s_n), -1))
    assert ES.launches["k8_bf16"] == before + len(layouts)


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 128, 128),
                                       (1, 132, 132), (1, 8, 8)])
def test_k6_bf16_wrapper_passes_the_layout(plain_lib, heads, o, d):
    """``_dot_softmax_kernel`` on bfloat16 CPU tensors hands the library
    its layout's four integers (the chooser's, or the caller's from the
    sweep build), and strips the scratch of their widest vector's lines:
    ``H * (ceil(2 O / 128) + 1) * E`` floats for bf16x8 and bf16x4 rows;
    the outputs are the plain version's bits."""
    # over the receiver CSR: q the 40 receivers', k and v the 50 senders'
    indptr, col, k, q, dy, *_ = _dot_inputs(heads, o, o, o + d)
    v = _dot_inputs(heads, d, d, o + d + 1)[8]
    args = (indptr, col, q, k, v, o ** -0.5, 0.2)
    n_edges = col.numel()
    raw, praw = (torch.empty(n_edges, heads) for _ in range(2))
    want = ES.dot_softmax_plain(*args, praw)
    for lay in (None, (0, 1, 2, 64), (1, 0, 4, 0)):
        got = ES._dot_softmax_kernel(*args, raw, lay)
        for a, b in zip(got + (raw,), want + (praw,)):
            assert torch.equal(a, b)
        _, passed, scratch = plain_lib.calls[-1]
        if lay is not None:
            assert passed == lay
        if passed[0]:
            assert scratch.numel() == heads * (-(-2 * o // 128) + 1) * n_edges
        else:
            assert scratch is None


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 128, 128),
                                       (1, 132, 132), (1, 8, 8), (2, 4, 12),
                                       (1, 13, 13)])
@pytest.mark.parametrize("given", [True, False])
def test_k7_bf16_wrapper_passes_the_layout(plain_lib, heads, o, d, given):
    """``_dot_bwd_dq_kernel`` on bfloat16 CPU tensors hands the library its
    layout's four integers (the chooser's, or the caller's from the sweep
    build) and, in strips only, the scratch of their widest vector's lines:
    ``H * (1 + ceil(D / S) + ceil(O / S)) * E`` floats without K6's raw
    logits, ``H * (1 + ceil(D / S)) * E`` with them; dq is the plain
    version's bits, from the raw logits where given."""
    indptr, col, k, q, dy, *_ = _dot_inputs(heads, o, o, o + d)
    v = _dot_inputs(heads, d, d, o + d + 1)[8]
    _, _, _, _, _, mx, den, s_n, dy = _dot_inputs(heads, d, d, o + d + 2)
    dy = dy[:40]
    mx, den, s_n = mx[:40], den[:40], s_n[:40]
    args = (indptr, col, q[:40], k, v, mx, den, s_n, dy, o ** -0.5, 0.2)
    n_edges = col.numel()
    raw = None
    if given:
        raw = torch.empty(n_edges, heads)
        ES.dot_softmax_plain(indptr, col, q[:40], k, v, o ** -0.5, 0.2, raw)
    want = ES.dot_bwd_dq_plain(*args, raw)
    ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
    lays = [None, (0, 1, 2, 64), (0, 0, 1, 64), (1, 0, 4, 0)]
    before = ES.launches["k7_bf16"]
    for lay in lays:
        got = ES._dot_bwd_dq_kernel(*args, raw, lay)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        _, passed, scratch = plain_lib.calls[-1]
        if lay is None:
            assert passed == ES._dot_recv_layout(ov, dv, vec, 50, 40,
                                                 n_edges, 2, 7)
        else:
            assert passed == lay
        if passed[0]:
            line = min(128 // vec, 32)
            strips = -(-dv // line) + (0 if given else -(-ov // line))
            assert scratch.numel() == heads * (1 + strips) * n_edges
        else:
            assert scratch is None
    assert ES.launches["k7_bf16"] == before + len(lays)


def test_bf16_rows_follow_the_table():
    """bfloat16 K6's, K7's and K8's rows per warp follow their table
    entry's index windows a row (at O = D = 32, 15.3 edges a row: 4 lanes
    of bf16x8 a group; K8's 4 windows make 8 rows a warp, K6's and K7's 2
    make 4); the float32 chooser is unchanged (three integers)."""
    assert ES._dot_bwd_rev_layout(8, 8, N, E) == (2, 2, 64)
    for table, lay, log_rows in (
            (ES._K8_BF16, ES._dot_bwd_rev_layout(4, 4, N, E, 16, 2), 3),
            (ES._K6_BF16, ES._dot_recv_layout(4, 4, 16, N, N, E, 2)[1:], 2),
            (ES._K7_BF16, ES._dot_recv_layout(4, 4, 16, N, N, E, 2,
                                              7)[1:], 2)):
        entry = next(e for most, e in table if 64 <= most)
        assert lay[0] == log_rows == S._windowed_rows(2, N, E, entry[-1])
        assert lay[1:] == entry[:-1][:len(lay) - 1]
