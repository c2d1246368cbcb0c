"""The layouts of K1 (``spmm_csr_f32``), K2 (``spmm_sddmm_csr_f32``), K6
(``dot_softmax_f32``), K7 (``dot_bwd_dq_f32``), K8 (``dot_bwd_rev_f32``),
K11 (``gatv2_bwd_rev_f32``), K10 (``gatv2_bwd_dq_f32``), K5
(``gat_bwd_rev_f32``), K9 (``gatv2_softmax_f32``), K3
(``gat_softmax_f32``), K12 (``edge_softmax_f32``) and K4
(``gat_bwd_dpi_f32``): their choosers, the wrappers passing a layout
through, and (``gpu``-marked) every layout on the card against the plain
versions.

- CPU: :func:`~ops.cuda.spmm._spmm_layout`,
  :func:`~ops.cuda.spmm._spmm_sddmm_layout`,
  :func:`~ops.cuda.edge_softmax._dot_recv_layout`,
  :func:`~ops.cuda.edge_softmax._dot_bwd_rev_layout`,
  :func:`~ops.cuda.edge_softmax._gatv2_bwd_rev_layout`,
  :func:`~ops.cuda.edge_softmax._gatv2_bwd_dq_layout`,
  :func:`~ops.cuda.edge_softmax._gat_bwd_rev_layout`,
  :func:`~ops.cuda.edge_softmax._gatv2_softmax_layout`,
  :func:`~ops.cuda.edge_softmax._gat_softmax_layout`,
  :func:`~ops.cuda.edge_softmax._edge_softmax_layout` and
  :func:`~ops.cuda.edge_softmax._gat_bwd_dpi_layout` give a layout the
  kernels take for every width, head count and mean row length, empty
  graphs included; the wrappers hand that layout (or the caller's) to the
  library call unchanged, with the scratch a strip layout or K10's ``da``
  needs and K5's and K11's packed scalars; K2's
  plain version takes heads as its per-head loop does.
- ``gpu``: each layout the sweep runs, on a graph with empty rows, a row of
  more than 32 edges and a row of more than 1024, against ``spmm_plain``,
  ``spmm_sddmm_plain``, ``dot_softmax_plain``, ``dot_bwd_dq_plain``,
  ``dot_bwd_rev_plain``, ``gatv2_bwd_rev_plain``, ``gatv2_bwd_dq_plain``,
  ``gat_bwd_rev_plain``, ``gatv2_softmax_plain``, ``gat_softmax_plain``,
  ``edge_softmax_plain`` and ``gat_bwd_dpi_plain``; two runs of each
  kernel give the same bits.
  This file imports no JAX, so on a machine with a card and no JAX it runs
  without the suite's conftest:

      python -m pytest tests/test_torch_spmm_layouts.py --noconftest -o addopts="" -m gpu
"""

import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402

MEAN_ROW_LENGTHS = [0, 0.5, 1, 3, 15.26, 100, 2048]
# The (unroll, reg_cap) pairs the shipped library holds for K12 and K4
# (csrc/edge_softmax.cu, K12Pick and K4Pick)
K12_INSTANCES = K4_INSTANCES = ((1, 0), (2, 64), (4, 64))
SPMM_SOURCE = (Path(S.__file__).resolve().parents[2] / "csrc"
               / "spmm.cu").read_text()


def _k2_pairs(name):
    """The (unroll, reg_cap) pairs a K2 pick of ``csrc/spmm.cu`` holds
    (its body's ``u == U && cap == C`` terms, and K2Pick's where it names
    it)."""
    body = re.search(r"struct %s \{(.*?)\};" % name, SPMM_SOURCE,
                     re.S).group(1)
    pairs = {tuple(int(x) for x in m) for m in re.findall(
        r"u == (\d+) && cap == (\d+)", body)}
    return pairs | (_k2_pairs("K2Pick") if "K2Pick::holds" in body else set())


# the pairs bfloat16 K2 takes (K2Bf16Pick: float32's and its table's;
# K2WalkPick: the all-heads walk's)
K2_BF16_PAIRS = _k2_pairs("K2Bf16Pick")
K2_WALK_PAIRS = _k2_pairs("K2WalkPick")


def _log_g(vectors: int) -> int:
    return min((vectors - 1).bit_length(), 5)


@pytest.mark.parametrize("mean", MEAN_ROW_LENGTHS)
def test_spmm_layout_is_valid_for_every_width(mean):
    """K1's chooser: a strip no wider than the row's G and at least one
    128-byte line unless the row is narrower, R rows of a strip fit in a
    warp, the unroll and the register cap are ones the kernel was built
    for; for tables small and large, empty graphs included."""
    for n_rows in (0, 1, 7, 131_072):
        entries = round(mean * n_rows)
        for table_rows in {n_rows, entries, 2_000_000}:
            for width in range(1, 1025):
                for fv, vb in {(width, 4), (max(1, width // 4), 16)}:
                    log_rows, strip, unroll, cap = S._spmm_layout(
                        fv, vb, table_rows, n_rows, entries)
                    assert 0 <= strip <= _log_g(fv)
                    assert vb << strip >= min(128, vb << _log_g(fv))
                    assert 0 <= log_rows <= 5 - strip
                    assert unroll in (1, 2, 4, 8) and cap in (0, 64)


@pytest.mark.parametrize("fv,vec_bytes,table_rows,want", [
    (32, 16, 131_072, (2, 3, 8, 64)),     # D=128 nodes: 16 MB strips
    (32, 16, 2_000_000, (0, 5, 8, 64)),   # [E, 128] edge rows: whole rows
    (32, 16, 4096, (0, 5, 8, 64)),        # a 2 MB table: whole rows
    (2, 16, 131_072, (2, 1, 2, 0)),       # D=8
    (7, 4, 131_072, (2, 3, 2, 0)),        # D=7, floats
    (129, 4, 131_072, (0, 5, 8, 64)),     # floats: 32 a line already
])
def test_spmm_layout_at_the_measured_shapes(fv, vec_bytes, table_rows, want):
    """The layouts K1 takes at N = 131,072, E = 2M (15.3 edges a row): the
    fastest of chip_smoke.py --sweep at D = 128, 8 and 7."""
    assert S._spmm_layout(fv, vec_bytes, table_rows, 131_072,
                          2_000_000) == want


@pytest.mark.parametrize("log_group,n_rows,entries,want", [
    (1, 131_072, 2_000_000, 2),   # D=8: 8 lanes a row, 4 groups of 2
    (3, 131_072, 2_000_000, 2),   # D=7: 8 lanes a row, one group of 8
    (0, 131_072, 2_000_000, 2),   # D=4: 8 lanes a row, 8 groups of 1
    (5, 131_072, 2_000_000, 0),   # D=128: one row per warp
    (2, 4096, 77_556, 2),         # 18.9 edges a row: 8 lanes
    (0, 1000, 64_000, 0),         # 64 edges a row: 32 lanes
    (0, 1000, 2_048_000, 0),      # 2,048 edges a row
    (0, 1000, 500, 5),            # half an edge a row: one lane
    (2, 1000, 500, 3),            # but at least one group of 4 lanes
    (0, 0, 0, 5),                 # no rows
])
def test_windowed_rows_rule(log_group, n_rows, entries, want):
    """K1's and K8's rows per warp: each row owns the power of two of lanes
    nearest its mean edges over ``windows`` (2), at least one edge group,
    at most 32."""
    assert S._K1_WINDOWS_PER_ROW == ES._K8_WINDOWS_PER_ROW == 2
    assert S._windowed_rows(log_group, n_rows, entries, 2) == want


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_dot_bwd_rev_layout_is_valid(n_rows, mean):
    """K8's chooser: R rows of G lanes fit in a warp, and (NC, U, cap) is
    an instance the kernel's library holds (NC = 1: U = 2 at 64 registers;
    wider: U = 1, no cap), for every width on either side up to 256 vectors
    (1024 floats), at each mean row length and for an empty graph."""
    for ov in range(1, 257):
        for dv in sorted({1, 7, 32, ov, 256}):
            wide = max(ov, dv)
            log_rows, unroll, cap = ES._dot_bwd_rev_layout(
                ov, dv, n_rows, round(mean * n_rows))
            assert 0 <= log_rows <= 5 - _log_g(wide)
            assert (unroll, cap) == ((2, 64) if wide <= 32 else (1, 0))


def test_dot_bwd_rev_layout_at_the_measured_shapes():
    """Transformer layer 1 (H=4, O=D=32: 8 float4 vectors a head) and its
    head layer (H=1, 2 vectors) take 4 rows per warp; AGNN (H=1, 32
    vectors) one row per warp, each with 2 edges in flight at 64
    registers: the fastest of chip_smoke.py --sweep. Rows of 64 vectors
    (O = D = 256) take one edge at a time, uncapped."""
    n, e = 131_072, 2_000_000
    assert ES._dot_bwd_rev_layout(8, 8, n, e) == (2, 2, 64)
    assert ES._dot_bwd_rev_layout(2, 2, n, e) == (2, 2, 64)
    assert ES._dot_bwd_rev_layout(32, 32, n, e) == (0, 2, 64)
    assert ES._dot_bwd_rev_layout(64, 64, n, e) == (0, 1, 0)


@pytest.mark.parametrize("mean", MEAN_ROW_LENGTHS)
def test_spmm_sddmm_layout_is_valid_for_every_width(mean):
    """K2's chooser: K1's strip and rows per warp; an (unroll, reg_cap)
    pair the shipped library holds for the group's width; the weights and
    dots by sender-CSR position for more than one head. For tables small
    and large, one head and four, empty graphs included."""
    for n_rows in (0, 1, 7, 131_072):
        entries = round(mean * n_rows)
        for table_rows in {n_rows, entries, 2_000_000}:
            for width in range(1, 1025):
                for fv, vb in {(width, 4), (max(1, width // 4), 16)}:
                    k1 = S._spmm_layout(fv, vb, table_rows, n_rows, entries)
                    for heads in (1, 4):
                        rows, strip, unroll, cap, by_position = (
                            S._spmm_sddmm_layout(fv, vb, table_rows, n_rows,
                                                 entries, heads))
                        assert (rows, strip) == k1[:2]
                        line = vb << strip >= 128
                        assert (unroll, cap) == (S._K2_WIDE if line else
                                                 S._K2_NARROW)
                        assert by_position == int(heads > 1)


@pytest.mark.parametrize("fv,vec_bytes,heads,want", [
    (32, 16, 1, (2, 3, 4, 64, 0)),   # D=128: 4 strips of a line
    (8, 16, 4, (2, 3, 4, 64, 1)),    # GAT (b) H=4, D=32: a head whole
    (2, 16, 1, (2, 1, 2, 0, 0)),     # D=8: whole rows, dots by edge id
    (7, 4, 1, (2, 3, 2, 0, 0)),      # D=7, floats
    (129, 4, 1, (0, 5, 4, 64, 0)),   # floats: 5 strips of a line
])
def test_spmm_sddmm_layout_at_the_measured_shapes(fv, vec_bytes, heads,
                                                  want):
    """The layouts K2 takes at N = 131,072, E = 2M (15.3 edges a row), from
    chip_smoke.py --sweep at D = 128, (4, 32) and 8: K1's strips (one line
    where a head's table exceeds 16 MB, else whole heads), 4 gathers in
    flight at 64 registers for a line, the weights and dots by sender-CSR
    position for several heads, by edge id for one."""
    assert S._spmm_sddmm_layout(fv, vec_bytes, 131_072, 131_072, 2_000_000,
                                heads) == want


@pytest.mark.parametrize("mean", MEAN_ROW_LENGTHS)
def test_spmm_sddmm_bf16_layout_is_valid_for_every_width(mean):
    """bfloat16 K2's chooser: for 1 to 4 and 8 heads of 1 to
    300 values in each vector they may take, over tables small and large,
    empty graphs included, a layout the shipped library builds: an
    (unroll, reg_cap) pair of K2Bf16Pick (the walk's of K2WalkPick); the
    all-heads walk (mode 2) only
    for 4 heads of a power of two of bf16x8 vectors that together fit
    ``_K2_BF16_ROW_BYTES``, one group of their lanes; else one head's
    strip (mode 0, one head; 1, several) that R rows fit a warp, one
    bf16x8 head of at most ``_K2_BF16_ROW_BYTES`` one whole-row strip."""
    for n_rows in (0, 7, 131_072):
        entries = round(mean * n_rows)
        for table_rows in {n_rows, 2_000_000}:
            for d in range(1, 301):
                for vb in (16, 8, 2):
                    fv = d // (vb // 2)
                    if fv * (vb // 2) != d:
                        continue
                    for heads in (1, 2, 3, 4, 8):
                        rows, strip, unroll, cap, mode = (
                            S._spmm_sddmm_bf16_layout(fv, vb, table_rows,
                                                      n_rows, entries,
                                                      heads))
                        walk = (vb == 16 and heads == 4
                                and fv & (fv - 1) == 0
                                and heads * fv * vb <= S._K2_BF16_ROW_BYTES)
                        assert mode == (2 if walk else int(heads > 1))
                        assert (unroll, cap) in (K2_WALK_PAIRS if walk
                                                 else K2_BF16_PAIRS)
                        if walk:
                            assert 1 << strip == heads * fv
                        else:
                            assert 0 <= strip <= _log_g(fv)
                            if (heads == 1 and vb == 16
                                    and fv * vb <= S._K2_BF16_ROW_BYTES):
                                assert strip == _log_g(fv)
                        assert 0 <= rows and rows + strip <= 5


def test_k2_bf16_table_is_built():
    """Each entry of ``_K2_BF16`` names a pair the shipped library holds
    (K2Bf16Pick), its last entry covers ``_K2_BF16_ROW_BYTES``, and the
    walk's ``_K2_BF16_WALK`` is K2WalkPick's one pair."""
    assert S._K2_BF16[-1][0] >= S._K2_BF16_ROW_BYTES
    for _, (unroll, cap, windows) in S._K2_BF16:
        assert (unroll, cap) in K2_BF16_PAIRS and windows > 0
    assert {S._K2_BF16_WALK[:2]} == K2_WALK_PAIRS


@pytest.mark.parametrize("fv,heads,want,f32", [
    # D=128: one whole-row strip, 32 MiB table
    (16, 1, (1, 4, 4, 64, 0), (2, 3, 4, 64, 0)),
    # GAT (b) H=4, D=32: the all-heads walk
    (4, 4, (1, 4, 2, 64, 2), (2, 2, 2, 0, 1)),
    # D=8: one bf16x8 lane a group
    (1, 1, (2, 0, 1, 64, 0), (2, 0, 2, 0, 0)),
    # H=4, D=128: by position, two strips
    (16, 4, (2, 3, 4, 64, 1), (2, 3, 4, 64, 1)),
    # three heads: by position
    (4, 3, (2, 2, 2, 0, 1), (2, 2, 2, 0, 1)),
])
def test_spmm_sddmm_bf16_layout_at_the_measured_shapes(fv, heads, want,
                                                       f32):
    """bfloat16 K2's layouts at N = 131,072, E = 2M (15.3 edges a row) on
    bf16x8 rows, from chip_smoke.py --sweep bf16_k2 (PERF.md §6); float32's
    chooser at the same vectors is unchanged (K1's strips, by position for
    several heads)."""
    n, e = 131_072, 2_000_000
    assert S._spmm_sddmm_bf16_layout(fv, 16, n, n, e, heads) == want
    # an unaligned weights' row: no all-heads walk
    if want[4] == 2:
        assert S._spmm_sddmm_bf16_layout(fv, 16, n, n, e, heads,
                                         heads_ok=False)[4] == 1
    assert S._spmm_sddmm_layout(fv, 16, n, n, e, heads) == f32


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gatv2_bwd_rev_layout_is_valid(n_rows, mean):
    """K11's chooser: K8's rows per warp for the head's G lanes, (U, cap)
    an instance the shipped library holds (rows of one register chunk
    ``(_K11_UNROLL, _K11_REG_CAP)``, wider ones one edge uncapped) and the
    receivers' scalars packed for edge groups narrower than a 128-byte
    line, for every width up to 256 vectors of float4 or float, at each
    mean row length and for an empty graph."""
    for vec_bytes in (4, 16):
        for ov in range(1, 257):
            log_rows, unroll, cap, packed = ES._gatv2_bwd_rev_layout(
                ov, vec_bytes, n_rows, round(mean * n_rows))
            assert packed == int(vec_bytes << _log_g(ov) < 128)
            assert 0 <= log_rows <= 5 - _log_g(ov)
            assert log_rows == ES._dot_bwd_rev_layout(
                ov, ov, n_rows, round(mean * n_rows))[0]
            assert (unroll, cap) == ((ES._K11_UNROLL, ES._K11_REG_CAP)
                                     if ov <= 32 else (1, 0))


def test_gatv2_bwd_rev_layout_at_the_measured_shapes():
    """GATv2 layer 1 (H=4, O=32: 8 float4 vectors a head) and its head
    layer (H=1, O=8: 2 vectors) take 4 rows per warp, (1, 128) one row per
    warp, each with the sweep's fastest edges in flight and register cap;
    rows of 64 vectors one edge at a time, uncapped. The head layer's
    32-byte groups read the receivers' scalars packed."""
    n, e = 131_072, 2_000_000
    assert ES._gatv2_bwd_rev_layout(8, 16, n, e) == (2, 2, 64, 0)
    assert ES._gatv2_bwd_rev_layout(2, 16, n, e) == (2, 2, 64, 1)
    assert ES._gatv2_bwd_rev_layout(32, 16, n, e) == (0, 2, 64, 0)
    assert ES._gatv2_bwd_rev_layout(64, 16, n, e) == (0, 1, 0, 0)
    assert ES._gatv2_bwd_rev_layout(7, 4, n, e) == (2, 2, 64, 1)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gatv2_bwd_dq_layout_is_valid(n_rows, mean):
    """K10's chooser: rows per warp for the head's G lanes at
    ``_K10_WINDOWS_PER_ROW`` index windows a row, and (U, cap) an instance
    the shipped library holds (rows of one register chunk K6's and K7's
    ``_DOT_ROWS_LINE`` for groups of a 128-byte line, ``_DOT_ROWS_NARROW``
    for narrower ones; wider rows one edge uncapped), for every width up
    to 256 vectors of float4 or float, at each mean row length and for an
    empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for ov in range(1, 257):
            log_rows, unroll, cap = ES._gatv2_bwd_dq_layout(
                ov, vec_bytes, n_rows, entries)
            assert 0 <= log_rows <= 5 - _log_g(ov)
            assert log_rows == S._windowed_rows(_log_g(ov), n_rows, entries,
                                                ES._K10_WINDOWS_PER_ROW)
            line = vec_bytes << _log_g(ov) >= 128
            assert (unroll, cap) == ((1, 0) if ov > 32 else
                                     ES._DOT_ROWS_LINE if line else
                                     ES._DOT_ROWS_NARROW)
            assert (unroll, cap) in ((1, 0), (2, 64), (4, 64))


def test_gatv2_bwd_dq_layout_at_the_measured_shapes():
    """GATv2 layer 1 (H=4, O=32: 8 float4 vectors a head, one 128-byte
    line) takes 4 rows per warp and 4 edges in flight at 64 registers, its
    head layer (H=1, O=8: 2 vectors) 8 rows per warp and 2 edges: the
    fastest of chip_smoke.py --sweep. (1, 128) one row per warp; rows of 64
    vectors one edge at a time, uncapped."""
    n, e = 131_072, 2_000_000
    assert ES._gatv2_bwd_dq_layout(8, 16, n, e) == (2, 4, 64)
    assert ES._gatv2_bwd_dq_layout(2, 16, n, e) == (3, 2, 64)
    assert ES._gatv2_bwd_dq_layout(32, 16, n, e) == (0, 4, 64)
    assert ES._gatv2_bwd_dq_layout(64, 16, n, e) == (0, 1, 0)
    assert ES._gatv2_bwd_dq_layout(7, 4, n, e) == (2, 2, 64)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gat_bwd_rev_layout_is_valid(n_rows, mean):
    """K5's chooser: K8's rows per warp for the head's G lanes (rows wider
    than 256 vectors go in passes of 256, on groups of 32 lanes), (U, cap)
    an instance the shipped library holds (as K10's) and the receivers'
    scalars packed for edge groups of at most ``_K5_PACK_UP_TO`` bytes,
    for every width up to 300 vectors of float4 or float, at each mean row
    length and for an empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for dv in range(0, 301):
            wide = min(max(dv, 1), 256)
            group = vec_bytes << _log_g(wide)
            log_rows, unroll, cap, packed = ES._gat_bwd_rev_layout(
                dv, vec_bytes, n_rows, entries)
            assert packed == int(group <= ES._K5_PACK_UP_TO)
            assert 0 <= log_rows <= 5 - _log_g(wide)
            assert log_rows == ES._dot_bwd_rev_layout(wide, wide, n_rows,
                                                      entries)[0]
            assert (unroll, cap) == ES._rows_instance(wide, group)
            assert (unroll, cap) in ((1, 0), (2, 64), (4, 64))
            assert wide <= 32 or (unroll, cap) == (1, 0)


def test_gat_bwd_rev_layout_at_the_measured_shapes():
    """GAT layer 1 (H=4, D=32: 8 float4 vectors a head, one 128-byte line)
    and its head layer (H=1, D=8: 2 vectors) take 4 rows per warp, 4 and 2
    edges in flight at 64 registers, and the receivers' scalars packed:
    the fastest of chip_smoke.py --sweep, the stack included. (1, 128) one
    row per warp, unpacked (groups of 512 bytes, not measured); rows of 64
    vectors or more one edge at a time, uncapped."""
    n, e = 131_072, 2_000_000
    assert ES._gat_bwd_rev_layout(8, 16, n, e) == (2, 4, 64, 1)
    assert ES._gat_bwd_rev_layout(2, 16, n, e) == (2, 2, 64, 1)
    assert ES._gat_bwd_rev_layout(32, 16, n, e) == (0, 4, 64, 0)
    assert ES._gat_bwd_rev_layout(64, 16, n, e) == (0, 1, 0, 0)
    assert ES._gat_bwd_rev_layout(275, 16, n, e) == (0, 1, 0, 0)
    assert ES._gat_bwd_rev_layout(7, 4, n, e) == (2, 2, 64, 1)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gatv2_softmax_layout_is_valid(n_rows, mean):
    """K9's chooser: rows per warp for the head's G lanes at
    ``_K9_WINDOWS_PER_ROW`` index windows a row, and (U, cap) an instance
    the shipped library holds (rows of one register chunk
    ``_K9_ROWS_LINE`` for groups of a 128-byte line, ``_K9_ROWS_NARROW``
    for narrower ones; wider rows one edge uncapped), for every width up
    to 256 vectors of float4 or float, at each mean row length and for an
    empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for ov in range(0, 257):
            log_rows, unroll, cap = ES._gatv2_softmax_layout(
                ov, vec_bytes, n_rows, entries)
            log_g = _log_g(max(ov, 1))
            assert 0 <= log_rows <= 5 - log_g
            assert log_rows == S._windowed_rows(log_g, n_rows, entries,
                                                ES._K9_WINDOWS_PER_ROW)
            line = vec_bytes << log_g >= 128
            assert (unroll, cap) == ((1, 0) if ov > 32 else
                                     ES._K9_ROWS_LINE if line else
                                     ES._K9_ROWS_NARROW)
            assert (unroll, cap) in ((1, 0), (2, 0), (4, 64))


def test_gatv2_softmax_layout_at_the_measured_shapes():
    """GATv2 layer 1 (H=4, O=32: 8 float4 vectors a head, one 128-byte
    line) takes 4 rows per warp and 4 edges in flight at 64 registers, its
    head layer (H=1, O=8: 2 vectors) 16 rows per warp and 2 edges,
    uncapped: the fastest of chip_smoke.py --sweep k9 (PERF.md §6; at (1,
    8) 8 rows a warp tie within 0.1 %). (1, 128) one row per warp; rows of
    64 vectors one edge at a time, uncapped."""
    n, e = 131_072, 2_000_000
    assert ES._gatv2_softmax_layout(8, 16, n, e) == (2, 4, 64)
    assert ES._gatv2_softmax_layout(2, 16, n, e) == (4, 2, 0)
    assert ES._gatv2_softmax_layout(32, 16, n, e) == (0, 4, 64)
    assert ES._gatv2_softmax_layout(64, 16, n, e) == (0, 1, 0)
    assert ES._gatv2_softmax_layout(7, 4, n, e) == (2, 2, 0)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gat_softmax_layout_is_valid(n_rows, mean):
    """K3's chooser: rows per warp for the head's G lanes at
    ``_K3_WINDOWS_PER_ROW`` (rows wider than 256 vectors go in passes of
    256, groups of 32 lanes), and (U, cap, ahead) with an instance the
    shipped library holds (rows of one register chunk ``_K3_ROWS_LINE``
    for groups of a 128-byte line, ``_K3_ROWS_NARROW`` for narrower ones;
    wider rows one edge uncapped, pj ahead), for every width up to 300
    vectors of float4 or float (0 included: K3 takes any D), at each mean
    row length and for an empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for dv in range(0, 301):
            wide = min(max(dv, 1), 256)
            log_rows, unroll, cap, ahead = ES._gat_softmax_layout(
                dv, vec_bytes, n_rows, entries)
            assert 0 <= log_rows <= 5 - _log_g(wide)
            assert log_rows == S._windowed_rows(_log_g(wide), n_rows,
                                                entries,
                                                ES._K3_WINDOWS_PER_ROW)
            line = vec_bytes << _log_g(wide) >= 128
            assert (unroll, cap, ahead) == (
                (1, 0, ES._K3_ROWS_LINE[2]) if wide > 32 else
                ES._K3_ROWS_LINE if line else ES._K3_ROWS_NARROW)
            assert (unroll, cap) in ((1, 0), (4, 64)) and ahead in (0, 1)


def test_gat_softmax_layout_at_the_measured_shapes():
    """GAT layer 1 (H=4, D=32: 8 float4 vectors a head, one 128-byte line)
    takes 4 rows per warp and 4 edges in flight at 64 registers with pj
    loaded ahead by the lane holding the index, its head layer (H=1, D=8: 2
    vectors) 4 rows per warp and one edge, uncapped, with pj loaded by
    every lane: the fastest of chip_smoke.py --sweep k3 (PERF.md §6). (1,
    128) one row per warp; rows of 64 vectors or more one edge at a time,
    uncapped, pj ahead (not measured)."""
    n, e = 131_072, 2_000_000
    assert ES._gat_softmax_layout(8, 16, n, e) == (2, 4, 64, 1)
    assert ES._gat_softmax_layout(2, 16, n, e) == (2, 1, 0, 0)
    assert ES._gat_softmax_layout(32, 16, n, e) == (0, 4, 64, 1)
    assert ES._gat_softmax_layout(64, 16, n, e) == (0, 1, 0, 1)
    assert ES._gat_softmax_layout(275, 16, n, e) == (0, 1, 0, 1)
    assert ES._gat_softmax_layout(7, 4, n, e) == (2, 1, 0, 0)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_edge_softmax_layout_is_valid(n_rows, mean):
    """K12's chooser: rows per warp for the head's G lanes at
    ``_K12_WINDOWS_PER_ROW`` (rows wider than 256 vectors go in passes of
    256, groups of 32 lanes), (U, cap) an instance the shipped library
    holds (rows of one register chunk ``_K12_ROWS_LINE`` for groups of a
    128-byte line, ``_K12_ROWS_NARROW`` for narrower ones; wider rows one
    edge uncapped), and the heads interleaved in the grid for edge values
    only; for every width up to 300 vectors of float4 or float (0 included: K12 takes any
    D), node and edge values, at each mean row length and for an empty
    graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for dv in range(0, 301):
            wide = min(max(dv, 1), 256)
            line = vec_bytes << _log_g(wide) >= 128
            for nodes in (True, False):
                log_rows, unroll, cap, interleave = (
                    ES._edge_softmax_layout(dv, vec_bytes, n_rows, entries,
                                            nodes))
                assert 0 <= log_rows <= 5 - _log_g(wide)
                assert log_rows == S._windowed_rows(
                    _log_g(wide), n_rows, entries, ES._K12_WINDOWS_PER_ROW)
                assert (unroll, cap) == (
                    (1, 0) if wide > 32 else
                    ES._K12_ROWS_LINE if line else ES._K12_ROWS_NARROW)
                assert interleave == (0 if nodes else 1)
                assert (unroll, cap) in K12_INSTANCES


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_gat_bwd_dpi_layout_is_valid(n_rows, mean):
    """K4's chooser: rows per warp for the head's G lanes at
    ``_K4_WINDOWS_PER_ROW`` (rows wider than 256 vectors go in passes of
    256, groups of 32 lanes), and (U, cap, ahead) with an instance the
    shipped library holds (rows of one register chunk ``_K4_ROWS_LINE``
    for groups of a 128-byte line, ``_K4_ROWS_NARROW`` for narrower ones;
    wider rows one edge uncapped, with ``_K4_ROWS_LINE``'s ahead), for
    every width up to 300 vectors of float4 or float (0 included: K4 takes
    any D), at each mean row length and for an empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        for dv in range(0, 301):
            wide = min(max(dv, 1), 256)
            log_rows, unroll, cap, ahead = ES._gat_bwd_dpi_layout(
                dv, vec_bytes, n_rows, entries)
            assert 0 <= log_rows <= 5 - _log_g(wide)
            assert log_rows == S._windowed_rows(_log_g(wide), n_rows,
                                                entries,
                                                ES._K4_WINDOWS_PER_ROW)
            line = vec_bytes << _log_g(wide) >= 128
            assert (unroll, cap, ahead) == (
                (1, 0, ES._K4_ROWS_LINE[2]) if wide > 32 else
                ES._K4_ROWS_LINE if line else ES._K4_ROWS_NARROW)
            assert (unroll, cap) in K4_INSTANCES and ahead in (0, 1)


def test_edge_softmax_layout_at_the_measured_shapes():
    """GAT (b) layer 1 (H=4, D=32: 8 float4 vectors a head, one 128-byte
    line) takes 4 rows per warp and 4 edges in flight at 64 registers,
    reading the logits and mask in place with a stride; its head layer
    (H=1, D=8: 2 vectors) 8 rows per warp and 2 edges at 64 registers: the
    fastest of chip_smoke.py --sweep k12 (PERF.md §6). Edge values take the
    same rows with the heads interleaved in the grid. (1, 128) one row per
    warp; rows of 64 vectors or more one edge at a time, uncapped."""
    n, e = 131_072, 2_000_000
    assert ES._edge_softmax_layout(8, 16, n, e, True) == (2, 4, 64, 0)
    assert ES._edge_softmax_layout(8, 16, n, e, False) == (2, 4, 64, 1)
    assert ES._edge_softmax_layout(2, 16, n, e, True) == (3, 2, 64, 0)
    assert ES._edge_softmax_layout(2, 16, n, e, False) == (3, 2, 64, 1)
    assert ES._edge_softmax_layout(32, 16, n, e, True) == (0, 4, 64, 0)
    assert ES._edge_softmax_layout(64, 16, n, e, True) == (0, 1, 0, 0)
    assert ES._edge_softmax_layout(275, 16, n, e, False) == (0, 1, 0, 1)
    assert ES._edge_softmax_layout(7, 4, n, e, True) == (2, 2, 64, 0)


def test_gat_bwd_dpi_layout_at_the_measured_shapes():
    """GAT (a) layer 1 (H=4, D=32: one 128-byte line a head) takes 4 rows
    per warp and 4 edges in flight at 64 registers with pj loaded ahead by
    the lane holding the index, its head layer (H=1, D=8: 2 vectors) 4 rows
    per warp and 2 edges at 64 registers with pj loaded by every lane: the
    fastest of chip_smoke.py --sweep k4 (PERF.md §6). (1, 128) one row per
    warp; rows of 64 vectors or more one edge at a time, uncapped, pj
    ahead (not measured)."""
    n, e = 131_072, 2_000_000
    assert ES._gat_bwd_dpi_layout(8, 16, n, e) == (2, 4, 64, 1)
    assert ES._gat_bwd_dpi_layout(2, 16, n, e) == (2, 2, 64, 0)
    assert ES._gat_bwd_dpi_layout(32, 16, n, e) == (0, 4, 64, 1)
    assert ES._gat_bwd_dpi_layout(64, 16, n, e) == (0, 1, 0, 1)
    assert ES._gat_bwd_dpi_layout(275, 16, n, e) == (0, 1, 0, 1)
    assert ES._gat_bwd_dpi_layout(7, 4, n, e) == (2, 2, 64, 0)


def test_sweep_build_is_a_library_of_its_own():
    """The sweep build of a source compiles with ``-DGNN_SWEEP`` into a
    library of another name, so the shipped one never holds its extra
    instances and neither build replaces the other."""
    from graphneuralnetworks_tpu_torch.ops.cuda import build as B

    for name in B.SOURCES:
        shipped, sweep = B._library_path(name, False), B._library_path(
            name, True)
        assert shipped != sweep and shipped.parent == sweep.parent
        assert sweep.name.startswith(f"{name}-sweep-")
    assert "-DGNN_SWEEP" not in B._flags(False)
    assert B._flags(True) == B.NVCC_FLAGS + ("-DGNN_SWEEP",)


class _FakeLib:
    """Stands in for a kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def _fake_launches(monkeypatch, module):
    """Fake libraries of ``module``: ``{False: shipped, True: sweep}``."""
    libs = {False: _FakeLib(), True: _FakeLib()}
    monkeypatch.setattr(module, "_lib", lambda sweep=False: libs[sweep])
    monkeypatch.setattr(module, "_call_on",
                        lambda device, fn, *args: fn(*args, None))
    return libs


@pytest.mark.parametrize("d", [7, 8, 128])
def test_spmm_wrapper_passes_the_layout(monkeypatch, d):
    """``_spmm_csr_kernel`` passes ``_spmm_layout``'s choice to the shipped
    library, or the caller's layout to the sweep build, as the last four
    integers before the stream."""
    libs = _fake_launches(monkeypatch, S)
    rng = np.random.default_rng(d)
    counts = rng.integers(0, 30, 64)
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    n_edges = int(indptr[-1])
    col = torch.tensor(rng.integers(0, 64, n_edges), dtype=torch.int32)
    x = torch.randn(64, d)
    before = S.launches["k1"]
    S._spmm_csr_kernel(indptr, col, None, None, x)
    S._spmm_csr_kernel(indptr, col, None, None, x, layout=(1, 0, 4, 0))
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    want = S._spmm_layout(d // 4 if vec else d, 16 if vec else 4, 64, 64,
                          n_edges)
    calls = libs[False].calls + libs[True].calls
    assert [c[1][-5:-1] for c in calls] == [want, (1, 0, 4, 0)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "spmm_csr_f32" for c in calls)
    assert S.launches["k1"] == before + 2


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (3, 5, 7)])
def test_dot_bwd_rev_wrapper_passes_the_layout(monkeypatch, heads, o, d):
    """``_dot_bwd_rev_kernel`` passes ``_dot_bwd_rev_layout``'s choice to
    the shipped library, or the caller's layout to the sweep build, as the
    three integers after the widths."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads + o + d)
    counts = rng.integers(0, 30, 40)
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    n_edges = int(indptr[-1])
    col = torch.tensor(rng.integers(0, 50, n_edges), dtype=torch.int32)
    q, dy = torch.randn(50, heads, o), torch.randn(50, heads, d)
    k, v = torch.randn(40, heads, o), torch.randn(40, heads, d)
    mx, den, s_n = (torch.randn(50, heads) for _ in range(3))
    args = (indptr, col, q, k, v, mx, den, s_n, dy, 0.5, None)
    before = ES.launches["k8"]
    ES._dot_bwd_rev_kernel(*args)
    ES._dot_bwd_rev_kernel(*args, layout=(0, 4, 64))
    vec = o % 4 == 0 and d % 4 == 0
    want = ES._dot_bwd_rev_layout(o // 4 if vec else o, d // 4 if vec else d,
                                  40, n_edges)
    calls = libs[False].calls + libs[True].calls
    assert [c[1][15:18] for c in calls] == [want, (0, 4, 64)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "dot_bwd_rev_f32" for c in calls)
    assert all(c[1][11:15] == (40, heads, o, d) for c in calls)
    assert ES.launches["k8"] == before + 2


def _csr(rng, n_rows, n_cols, empty_every=0):
    """A random CSR of ``n_rows`` rows of 0-29 edges into ``n_cols``
    columns (every ``empty_every``-th row empty), int32 on the CPU."""
    counts = rng.integers(0, 30, n_rows)
    if empty_every:
        counts[::empty_every] = 0
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    col = torch.tensor(rng.integers(0, n_cols, int(indptr[-1])),
                       dtype=torch.int32)
    return indptr, col


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 8), (3, 7)])
def test_spmm_sddmm_wrapper_passes_the_layout(monkeypatch, heads, d):
    """``_spmm_sddmm_kernel`` passes ``_spmm_sddmm_layout``'s choice to the
    shipped library, or the caller's layout to the sweep build, as the last
    five integers before the stream, after ``(rows, H, D, E, float4)``.
    Scratch: by position ``H * (strips + 1) * E`` floats with weights, ``H
    * strips * E`` without; else ``H * strips * E`` where strips split a
    head, none for one strip a head. One head takes rows of ``[., D]``."""
    libs = _fake_launches(monkeypatch, S)
    rng = np.random.default_rng(heads * 10 + d)
    indptr, col = _csr(rng, 40, 50)
    n_edges = col.numel()
    eid = torch.tensor(rng.permutation(n_edges), dtype=torch.int32)
    shape = (heads, d) if heads > 1 else (d,)
    dy, x = torch.randn(50, *shape), torch.randn(40, *shape)
    w = torch.rand(n_edges, *shape[:-1])
    allocs = []
    empty = torch.empty
    monkeypatch.setattr(S.torch, "empty", lambda *a, **kw: allocs.append(
        a[0]) or empty(*a, **kw))
    before = S.launches["k2"]
    dx, dw = S._spmm_sddmm_kernel(indptr, col, eid, w, dy, x)
    assert dx.shape == x.shape and dw.shape == (n_edges,) + shape[:-1]
    scratch = [allocs[1:]]
    layouts = [(1, 0, 4, 0, 1), (1, 0, 4, 0, 0)]
    for lay in layouts:
        allocs.clear()
        S._spmm_sddmm_kernel(indptr, col, eid, None, dy, x, layout=lay)
        scratch.append(allocs[1:])
    vec = d % 4 == 0
    fv = d // 4 if vec else d
    want = S._spmm_sddmm_layout(fv, 16 if vec else 4, 50, 40, n_edges,
                                heads)
    calls = libs[False].calls + libs[True].calls
    assert [c[1][-6:-1] for c in calls] == [want] + layouts
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 2]
    assert all(c[0] == "spmm_sddmm_csr_f32" for c in calls)
    assert all(c[1][9:14] == (40, heads, d, n_edges, 16 if vec else 4)
               for c in calls)
    strips = -(-fv >> want[1])
    assert want[4] == int(heads > 1)
    assert scratch == [[heads * (strips + 1) * n_edges] if want[4] else [],
                       [heads * fv * n_edges],             # no weights
                       [heads * fv * n_edges] if fv > 1 else []]
    assert (calls[2][1][8] is None) == (fv == 1)
    assert calls[1][1][3] is None                  # w = None
    assert S.launches["k2"] == before + 3


class _K2StandIn:
    """Stands in for the K2 library on bfloat16 CPU tensors (``_ptr``
    passes the tensors themselves): checks each call's integers and scratch
    as ``spmm_sddmm_csr_bf16`` takes them (mode 2: 4 heads of a power of
    two of bf16x8 vectors, one group of their lanes, no scratch;
    mode 1: ``H * (strips + 1) * E`` floats with weights, ``H * strips *
    E`` without; mode 0: ``H * strips * E`` past one strip, else none) and
    writes the plain version's outputs."""

    def __init__(self):
        self.calls = []

    def spmm_sddmm_csr_bf16(self, indptr, col, eid, w, dy, x, dx, dw,
                            scratch, n_rows, heads, d, n_edges, vec,
                            log_rows, log_strip, unroll, cap, mode, stream):
        self.calls.append(((log_rows, log_strip, unroll, cap, mode),
                           None if scratch is None else scratch.numel()))
        fv = d // (vec // 2)
        strips = -(-fv >> log_strip)
        assert log_rows + log_strip <= 5
        assert (unroll, cap) in (K2_WALK_PAIRS if mode == 2
                                 else K2_BF16_PAIRS)
        if mode == 2:
            assert vec == 16 and heads == 4 and fv & (fv - 1) == 0
            assert 1 << log_strip == heads * fv and scratch is None
        elif mode == 1:
            assert scratch.numel() == heads * (strips + (w is not None)) \
                * n_edges
        else:
            assert mode == 0 and (scratch.numel() if strips > 1 else None) \
                == (heads * strips * n_edges if strips > 1 else None)
        a, b = S.spmm_sddmm_plain(indptr, col, eid, w, dy, x)
        dx.copy_(a)
        dw.copy_(b)
        return 0


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("d", [8, 32, 128])
def test_spmm_sddmm_bf16_stand_in_route_matches_plain(monkeypatch, heads,
                                                      d):
    """``_spmm_sddmm_kernel`` on bfloat16 CPU tensors, through a stand-in
    library that checks the layout's integers and the scratch it was given
    (none for the all-heads walk or one strip): dx and dw are
    ``spmm_sddmm_plain``'s bits, weighted and unweighted, at the chooser's
    layout and at one of each mode the rows take; the chooser's is the
    walk at 4 heads of 8 or 32 values and one whole-row strip at one
    head."""
    lib = _K2StandIn()
    monkeypatch.setattr(S, "_lib", lambda sweep=False: lib)
    monkeypatch.setattr(S, "_ptr", lambda t: t)
    monkeypatch.setattr(S, "_call_on", lambda device, fn, *a: fn(*a, None))
    rng = np.random.default_rng(heads * 100 + d)
    indptr, col = _csr(rng, 40, 50, empty_every=7)
    n_edges = col.numel()
    eid = torch.tensor(rng.permutation(n_edges), dtype=torch.int32)
    shape = (heads, d) if heads > 1 else (d,)

    def bf(*sh):
        return torch.tensor(rng.standard_normal(sh),
                            dtype=torch.float32).bfloat16()

    dy, x, w = bf(50, *shape), bf(40, *shape), bf(n_edges, *shape[:-1])
    fv = d // 8
    lg = _log_g(fv)
    lays = [None, (1, lg, 2, 0, 0), (1, lg, 2, 0, 1)]
    if heads > 1 and heads * fv <= 32:
        lays.append((0, _log_g(heads * fv), 2, 64, 2))
    if fv > 8:
        lays.append((2, 3, 4, 64, 0))
    before = S.launches["k2_bf16"]
    for ww in (w, None):
        want = S.spmm_sddmm_plain(indptr, col, eid, ww, dy, x)
        for lay in lays:
            got = S._spmm_sddmm_kernel(indptr, col, eid, ww, dy, x,
                                       layout=lay)
            for a, b in zip(got, want):
                assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    chosen = lib.calls[0][0]
    assert chosen == S._spmm_sddmm_bf16_layout(fv, 16, 50, 40, n_edges,
                                               heads)
    # the wrapper records its last launch: the layout and a head's strips
    assert S.last_layout["k2_bf16"] == (lib.calls[-1][0],
                                        -(-fv >> lib.calls[-1][0][1]))
    assert chosen[4] == (2 if heads == 4 and d < 128 else int(heads > 1))
    if heads == 1:
        assert chosen[1] == lg and lib.calls[0][1] is None
    assert S.launches["k2_bf16"] == before + 2 * len(lays)


def test_spmm_sddmm_bf16_walk_needs_aligned_weights(monkeypatch):
    """The all-heads walk loads an edge's H weights at once: weights whose
    rows are not aligned to H values (a view one value in) take the
    position route (mode 1) instead, with its scratch."""
    lib = _K2StandIn()
    monkeypatch.setattr(S, "_lib", lambda sweep=False: lib)
    monkeypatch.setattr(S, "_ptr", lambda t: t)
    monkeypatch.setattr(S, "_call_on", lambda device, fn, *a: fn(*a, None))
    rng = np.random.default_rng(3)
    indptr, col = _csr(rng, 40, 50)
    n_edges = col.numel()
    dy = torch.randn(50, 4, 32).bfloat16()
    x = torch.randn(40, 4, 32).bfloat16()
    flat = torch.randn(n_edges * 4 + 1).bfloat16()
    for w, mode in ((flat[:-1].view(n_edges, 4), 2),
                    (flat[1:].view(n_edges, 4), 1)):
        S._spmm_sddmm_kernel(indptr, col, None, w, dy, x)
        assert lib.calls[-1][0][4] == mode
        assert (lib.calls[-1][1] is None) == (mode == 2)


@pytest.mark.parametrize("heads,o", [(4, 32), (1, 8), (3, 7)])
def test_gatv2_bwd_rev_wrapper_passes_the_layout(monkeypatch, heads, o):
    """``_gatv2_bwd_rev_kernel`` passes ``_gatv2_bwd_rev_layout``'s choice
    to the shipped library, or the caller's layout to the sweep build, as
    the three integers after ``(rows, H, O)``; a packed layout hands the
    kernel ``(mx, den, s_n)`` stacked as ``[rows, H, 4]`` after ``s_n``."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads + o)
    indptr, col = _csr(rng, 40, 50)
    q, dy = torch.randn(50, heads, o), torch.randn(50, heads, o)
    k, a = torch.randn(40, heads, o), torch.randn(o, heads)
    mx, den, s_n = (torch.randn(50, heads) for _ in range(3))
    args = (indptr, col, q, k, a, mx, den, s_n, dy, 0.2)
    stacks = []
    stack = torch.stack
    monkeypatch.setattr(ES.torch, "stack", lambda *a, **kw: stacks.append(
        stack(*a, **kw)) or stacks[-1])
    before = ES.launches["k11"]
    ES._gatv2_bwd_rev_kernel(*args)
    ES._gatv2_bwd_rev_kernel(*args, layout=(0, 4, 64, 1))
    vec = o % 4 == 0
    want = ES._gatv2_bwd_rev_layout(o // 4 if vec else o, 16 if vec else 4,
                                    40, col.numel())
    calls = libs[False].calls + libs[True].calls
    assert [c[1][14:17] for c in calls] == [want[:3], (0, 4, 64)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "gatv2_bwd_rev_f32" for c in calls)
    assert all(c[1][11:14] == (40, heads, o) for c in calls)
    assert (calls[0][1][8] is None) == (not want[3])
    (st,) = stacks[-1:]
    assert calls[1][1][8] == st.data_ptr() and st.shape == (50, heads, 4)
    assert torch.equal(st[..., :3], torch.stack((mx, den, s_n), -1))
    assert ES.launches["k11"] == before + 2


@pytest.mark.parametrize("heads,o", [(4, 32), (1, 8), (3, 7)])
def test_gatv2_bwd_dq_wrapper_passes_the_layout(monkeypatch, heads, o):
    """``_gatv2_bwd_dq_kernel`` passes ``_gatv2_bwd_dq_layout``'s choice
    to the shipped library, or the caller's layout to the sweep build, as
    the three integers after ``(rows, H, O)``; the dq walk gets scratch of
    ``[H, O, blocks]`` for the blocks' shares of ``da``, and the second
    launch, from the same library, reads it with the same block count and
    writes ``da [O, H]``."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 7 + o)
    indptr, col = _csr(rng, 40, 50)
    q, dy = torch.randn(40, heads, o), torch.randn(40, heads, o)
    k, a = torch.randn(50, heads, o), torch.randn(o, heads)
    mx, den, s_n = (torch.randn(40, heads) for _ in range(3))
    args = (indptr, col, q, k, a, mx, den, s_n, dy, 0.2)
    allocs = []
    empty = torch.empty
    monkeypatch.setattr(ES.torch, "empty", lambda *a, **kw: allocs.append(
        a[0]) or empty(*a, **kw))
    before = ES.launches["k10"]
    dq, da = ES._gatv2_bwd_dq_kernel(*args)
    assert dq.shape == (40, heads, o) and da.shape == (o, heads)
    ES._gatv2_bwd_dq_kernel(*args, layout=(0, 4, 64))
    vec = o % 4 == 0
    want = ES._gatv2_bwd_dq_layout(o // 4 if vec else o, 16 if vec else 4,
                                   40, col.numel())
    for lib, lay in ((libs[False], want), (libs[True], (0, 4, 64))):
        (walk, walk_args), (red, red_args) = lib.calls
        assert (walk, red) == ("gatv2_bwd_dq_f32", "gatv2_da_reduce_f32")
        assert walk_args[11:17] == (40, heads, o) + lay
        blocks = ES._dq_blocks(40, lay[0])
        assert (heads, o, blocks) in allocs
        assert red_args[0] == walk_args[10]
        assert red_args[2:5] == (blocks, heads, o)
    assert ES.launches["k10"] == before + 4


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 8), (3, 7)])
def test_gat_bwd_rev_wrapper_passes_the_layout(monkeypatch, heads, d):
    """``_gat_bwd_rev_kernel`` passes ``_gat_bwd_rev_layout``'s choice to
    the shipped library, or the caller's layout to the sweep build, as the
    three integers after ``(rows, H, D)``; a packed layout hands the kernel
    ``(pi, mx, den, s_n)`` stacked as ``[rows, H, 4]`` after ``s_n``."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 3 + d)
    indptr, col = _csr(rng, 40, 50)
    pi, mx, den, s_n = (torch.randn(50, heads) for _ in range(4))
    pj, v = torch.randn(40, heads), torch.randn(40, heads, d)
    dy = torch.randn(50, heads, d)
    args = (indptr, col, pi, pj, v, mx, den, s_n, dy, 0.2)
    stacks = []
    stack = torch.stack
    monkeypatch.setattr(ES.torch, "stack", lambda *a, **kw: stacks.append(
        stack(*a, **kw)) or stacks[-1])
    before = ES.launches["k5"]
    dpj, dv = ES._gat_bwd_rev_kernel(*args)
    assert dpj.shape == (40, heads) and dv.shape == (40, heads, d)
    ES._gat_bwd_rev_kernel(*args, layout=(0, 4, 64, 1))
    vec = d % 4 == 0
    want = ES._gat_bwd_rev_layout(d // 4 if vec else d, 16 if vec else 4,
                                  40, col.numel())
    calls = libs[False].calls + libs[True].calls
    assert [c[1][15:18] for c in calls] == [want[:3], (0, 4, 64)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "gat_bwd_rev_f32" for c in calls)
    assert all(c[1][12:15] == (40, heads, d) for c in calls)
    assert (calls[0][1][8] is None) == (not want[3])
    st = stacks[-1]
    assert calls[1][1][8] == st.data_ptr() and st.shape == (50, heads, 4)
    assert torch.equal(st, stack((pi, mx, den, s_n), -1))
    assert calls[1][1][9] == dy.data_ptr()
    assert ES.launches["k5"] == before + 2


@pytest.mark.parametrize("heads,o", [(4, 32), (1, 8), (3, 7)])
def test_gatv2_softmax_wrapper_passes_the_layout(monkeypatch, heads, o):
    """``_gatv2_softmax_kernel`` passes ``_gatv2_softmax_layout``'s choice
    to the shipped library, or the caller's layout to the sweep build, as
    the three integers after ``(rows, H, O)``: one launch a call."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 5 + o)
    indptr, col = _csr(rng, 40, 50)
    q, k, a = torch.randn(40, heads, o), torch.randn(50, heads, o), \
        torch.randn(o, heads)
    before = ES.launches["k9"]
    num, m, s = ES._gatv2_softmax_kernel(indptr, col, q, k, a, 0.2)
    assert num.shape == (40, heads, o) and m.shape == s.shape == (40, heads)
    ES._gatv2_softmax_kernel(indptr, col, q, k, a, 0.2, layout=(0, 4, 64))
    vec = o % 4 == 0
    want = ES._gatv2_softmax_layout(o // 4 if vec else o, 16 if vec else 4,
                                    40, col.numel())
    calls = libs[False].calls + libs[True].calls
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "gatv2_softmax_f32" for c in calls)
    assert [c[1][8:14] for c in calls] == [(40, heads, o) + want,
                                           (40, heads, o, 0, 4, 64)]
    assert all(c[1][2:5] == tuple(t.data_ptr() for t in (q, k, a))
               for c in calls)
    assert all(c[1][14] == pytest.approx(0.2) for c in calls)
    assert ES.launches["k9"] == before + 2


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 8), (3, 7), (1, 1100),
                                     (2, 0)])
def test_gat_softmax_wrapper_passes_the_layout(monkeypatch, heads, d):
    """``_gat_softmax_kernel`` passes ``_gat_softmax_layout``'s choice to
    the shipped library, or the caller's layout to the sweep build, as the
    four integers after ``(rows, H, D)``: one launch a call, at any D."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 11 + d)
    indptr, col = _csr(rng, 40, 50)
    pi, pj, v = torch.randn(40, heads), torch.randn(50, heads), \
        torch.randn(50, heads, d)
    before = ES.launches["k3"]
    num, m, s = ES._gat_softmax_kernel(indptr, col, pi, pj, v, 0.2)
    assert num.shape == (40, heads, d) and m.shape == s.shape == (40, heads)
    ES._gat_softmax_kernel(indptr, col, pi, pj, v, 0.2, layout=(0, 4, 64, 0))
    vec = d % 4 == 0
    want = ES._gat_softmax_layout(d // 4 if vec else d, 16 if vec else 4,
                                  40, col.numel())
    calls = libs[False].calls + libs[True].calls
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "gat_softmax_f32" for c in calls)
    assert [c[1][8:15] for c in calls] == [(40, heads, d) + want,
                                           (40, heads, d, 0, 4, 64, 0)]
    assert all(c[1][2:5] == tuple(t.data_ptr() for t in (pi, pj, v))
               for c in calls)
    assert ES.launches["k3"] == before + 2


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 8), (3, 7), (1, 1100),
                                     (2, 0)])
def test_edge_softmax_wrapper_passes_the_layout(monkeypatch, heads, d):
    """``_edge_softmax_kernel`` passes ``_edge_softmax_layout``'s choice to
    the shipped library, or the caller's layout to the sweep build, as the
    four integers after ``(rows, H, D)``, with the caller's ``[E, H]``
    logits and mask in place: one launch a call, at any D, with node values
    (``col``) and edge values (no ``col``), with and without a mask."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 13 + d)
    indptr, col = _csr(rng, 40, 50)
    n_edges = col.numel()
    lg, mask = torch.randn(n_edges, heads), torch.rand(n_edges, heads)
    v, ve = torch.randn(50, heads, d), torch.randn(n_edges, heads, d)
    layouts = [(0, 4, 64, 0), (1, 2, 0, 1)]
    before = ES.launches["k12"]
    for c, vals, mk in ((col, v, None), (col, v, mask), (None, ve, mask)):
        for lib in libs.values():
            lib.calls.clear()
        num, m, s = ES._edge_softmax_kernel(indptr, c, lg, mk, vals)
        assert num.shape == (40, heads, d) and m.shape == s.shape == (
            40, heads)
        for lay in layouts:
            ES._edge_softmax_kernel(indptr, c, lg, mk, vals, layout=lay)
        vec = d % 4 == 0
        want = ES._edge_softmax_layout(d // 4 if vec else d, 16 if vec else 4,
                                       40, n_edges, c is not None)
        calls = libs[False].calls + libs[True].calls
        assert [len(libs[False].calls), len(libs[True].calls)] == [1, 2]
        assert all(name == "edge_softmax_f32" for name, _ in calls)
        assert [a[8:15] for _, a in calls] == [
            (40, heads, d) + lay for lay in [want] + layouts]
        for _, a in calls:
            assert a[0:5] == (indptr.data_ptr(), ES._ptr(c), lg.data_ptr(),
                              ES._ptr(mk), vals.data_ptr())
    assert ES.launches["k12"] == before + 9


@pytest.mark.parametrize("heads,d", [(4, 32), (1, 8), (3, 7), (1, 1100),
                                     (2, 0)])
def test_gat_bwd_dpi_wrapper_passes_the_layout(monkeypatch, heads, d):
    """``_gat_bwd_dpi_kernel`` passes ``_gat_bwd_dpi_layout``'s choice to
    the shipped library, or the caller's layout to the sweep build, as the
    four integers after ``(rows, H, D)``, with every operand's pointer and
    the slope: one launch a call, at any D."""
    libs = _fake_launches(monkeypatch, ES)
    rng = np.random.default_rng(heads * 17 + d)
    indptr, col = _csr(rng, 40, 50)
    pi, mx, den, s_n = (torch.randn(40, heads) for _ in range(4))
    pj, v = torch.randn(50, heads), torch.randn(50, heads, d)
    dy = torch.randn(40, heads, d)
    args = (indptr, col, pi, pj, v, mx, den, s_n, dy, 0.2)
    before = ES.launches["k4"]
    dpi = ES._gat_bwd_dpi_kernel(*args)
    assert dpi.shape == (40, heads)
    ES._gat_bwd_dpi_kernel(*args, layout=(0, 4, 64, 0))
    vec = d % 4 == 0
    want = ES._gat_bwd_dpi_layout(d // 4 if vec else d, 16 if vec else 4,
                                  40, col.numel())
    calls = libs[False].calls + libs[True].calls
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 1]
    assert all(c[0] == "gat_bwd_dpi_f32" for c in calls)
    assert [c[1][10:17] for c in calls] == [(40, heads, d) + want,
                                            (40, heads, d, 0, 4, 64, 0)]
    assert all(c[1][:9] == tuple(t.data_ptr() for t in args[:9])
               for c in calls)
    assert calls[0][1][9] == dpi.data_ptr()
    assert all(c[1][17] == pytest.approx(0.2) for c in calls)
    assert ES.launches["k4"] == before + 2


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_sddmm_plain_takes_heads(weighted):
    """``spmm_sddmm_plain`` on rows of ``[., H, D]`` gives, bit for bit in
    float64, what a loop over the heads gives on ``[., D]`` slices: over a
    sender CSR with empty rows and an ``eid`` permutation, a bipartite ``x``
    (40 senders) against ``dy`` of 50 receivers, weighted or not."""
    rng = np.random.default_rng(7)
    indptr, col = _csr(rng, 40, 50, empty_every=3)
    n_edges = col.numel()
    eid = torch.tensor(rng.permutation(n_edges), dtype=torch.int32)
    heads, d = 3, 5
    dy = torch.tensor(rng.standard_normal((50, heads, d)))
    x = torch.tensor(rng.standard_normal((40, heads, d)))
    w = torch.tensor(rng.random((n_edges, heads))) if weighted else None
    dx, dw = S.spmm_sddmm_plain(indptr, col, eid, w, dy, x)
    assert dx.shape == x.shape and dw.shape == (n_edges, heads)
    assert (dx[::3] == 0).all()
    for h in range(heads):
        dxh, dwh = S.spmm_sddmm_plain(
            indptr, col, eid, None if w is None else w[:, h].contiguous(),
            dy[:, h].contiguous(), x[:, h].contiguous())
        assert torch.equal(dx[:, h], dxh) and torch.equal(dw[:, h], dwh)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (131_072, m) for m in MEAN_ROW_LENGTHS])
def test_dot_recv_layout_is_valid(n_rows, mean):
    """K6's and K7's chooser: strips only for a head wider than one
    128-byte line, with R rows of one-line groups in a warp and the strip
    instance the library holds; else K8's rows per warp, with (U, cap) an
    instance the library holds: for rows of one register chunk 4 edges in
    flight for groups of a line or more, 2 for narrower, at 64 registers;
    one edge uncapped for wider rows. For every width on either side up to
    256 vectors of float4 or float, small and large sender tables, each
    mean row length and an empty graph."""
    entries = round(mean * n_rows)
    for vec_bytes in (4, 16):
        line = 128 // vec_bytes
        for n_src in (n_rows, 4096, 131_072):
            for ov in range(1, 257):
                for dv in sorted({1, 7, 32, ov, 256}):
                    wide = max(ov, dv)
                    lay = ES._dot_recv_layout(ov, dv, vec_bytes, n_src,
                                              n_rows, entries)
                    if lay[0]:
                        assert wide > line
                        assert n_src * wide * vec_bytes > 16 * 2**20
                        assert 0 <= lay[1] <= 5 - _log_g(line)
                        assert lay[2:] == ES._DOT_STRIP_INSTANCE
                    else:
                        rows = ES._dot_bwd_rev_layout(ov, dv, n_rows,
                                                      entries)
                        assert lay[1] == rows[0]
                        line_group = vec_bytes << _log_g(wide) >= 128
                        assert lay[2:] == ((1, 0) if wide > 32 else
                                           (4, 64) if line_group else
                                           (2, 64))


@pytest.mark.parametrize("ov,dv,vec_bytes,n_src,want", [
    (8, 8, 16, 131_072, (0, 2, 4, 64)),     # Transformer layer 1 (4, 32, 32)
    (2, 2, 16, 131_072, (0, 2, 2, 64)),     # its head layer (1, 8, 8)
    (32, 32, 16, 131_072, (1, 2, 4, 0)),    # AGNN (1, 128, 128): strips
    (64, 64, 16, 131_072, (1, 2, 4, 0)),    # (1, 256, 256)
    (32, 32, 16, 2_708, (0, 0, 4, 64)),     # a 1.4 MB table: rows
    (64, 64, 16, 2_708, (0, 0, 1, 0)),      # two register chunks: rows
    (67, 5, 4, 131_072, (1, 0, 4, 0)),      # floats: one group a line
])
def test_dot_recv_layout_at_the_measured_shapes(ov, dv, vec_bytes, n_src,
                                                want):
    """The layouts K6 and K7 take at N = 131,072, E = 2M (15.3 edges a
    row), the fastest of chip_smoke.py --sweep: rows at the Transformer's
    shapes, strips of one line at AGNN's, whose 64 MB tables the L2 cannot
    hold."""
    assert ES._dot_recv_layout(ov, dv, vec_bytes, n_src, 131_072,
                               2_000_000) == want


def _dot_inputs(heads, o, d, n_dst=50, n_src=40, seed=0):
    """A receiver CSR of ``n_dst`` rows over ``n_src`` senders, and random
    float32 q, k, v, dy, mx, den, s_n on the CPU."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, n_dst)
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    col = torch.tensor(rng.integers(0, n_src, int(indptr[-1])),
                       dtype=torch.int32)
    q, dy = torch.randn(n_dst, heads, o), torch.randn(n_dst, heads, d)
    k, v = torch.randn(n_src, heads, o), torch.randn(n_src, heads, d)
    mx, den, s_n = (torch.randn(n_dst, heads) for _ in range(3))
    return indptr, col, q, k, v, dy, mx, den, s_n


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (3, 5, 7),
                                       (1, 128, 128)])
def test_dot_softmax_wrapper_passes_the_layout(monkeypatch, heads, o, d):
    """``_dot_softmax_kernel`` passes ``_dot_recv_layout``'s choice to the
    shipped library, or the caller's layout to the sweep build, as the four
    integers after the edge count; a strip layout gets ``raw`` (the
    caller's, else its own) and scratch of ``H * (strips + 1) * E``
    floats."""
    libs = _fake_launches(monkeypatch, ES)
    indptr, col, q, k, v, *_ = _dot_inputs(heads, o, d, seed=heads + o + d)
    n_edges = col.numel()
    args = (indptr, col, q, k, v, 0.5, None)
    allocs = []
    empty = torch.empty
    monkeypatch.setattr(ES.torch, "empty", lambda *a, **kw: allocs.append(
        a[0]) or empty(*a, **kw))
    raw = torch.empty(n_edges, heads)
    before = ES.launches["k6"]
    ES._dot_softmax_kernel(*args)
    ES._dot_softmax_kernel(*args, raw_out=raw, layout=(0, 1, 4, 0))
    ES._dot_softmax_kernel(*args, layout=(1, 0, 8, 64))
    vec = o % 4 == 0 and d % 4 == 0
    want = ES._dot_recv_layout(o // 4 if vec else o, d // 4 if vec else d,
                               16 if vec else 4, 40, 50, n_edges)
    calls = libs[False].calls + libs[True].calls
    assert [c[1][15:19] for c in calls] == [want, (0, 1, 4, 0), (1, 0, 8,
                                                                 64)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [1, 2]
    assert all(c[0] == "dot_softmax_f32" for c in calls)
    assert all(c[1][10:15] == (50, heads, o, d, n_edges) for c in calls)
    assert calls[1][1][8] == raw.data_ptr() and calls[1][1][9] is None
    assert calls[2][1][8] is not None and calls[2][1][9] is not None
    strips = -(-(o // 4 if vec else o) // (8 if vec else 32))
    assert heads * (strips + 1) * n_edges in allocs
    assert ES.launches["k6"] == before + 3


@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (3, 5, 7),
                                       (2, 128, 64)])
def test_dot_bwd_dq_wrapper_passes_the_layout(monkeypatch, heads, o, d):
    """``_dot_bwd_dq_kernel`` passes the layout as K6's wrapper does and
    ``raw`` as given; a strip layout gets scratch for the weights and the
    partial ``<v, dy>`` of every strip, and without ``raw`` for the
    partial logits too."""
    libs = _fake_launches(monkeypatch, ES)
    indptr, col, q, k, v, dy, mx, den, s_n = _dot_inputs(
        heads, o, d, seed=heads * o + d)
    n_edges = col.numel()
    raw = torch.randn(n_edges, heads)
    allocs = []
    empty = torch.empty
    monkeypatch.setattr(ES.torch, "empty", lambda *a, **kw: allocs.append(
        a[0]) or empty(*a, **kw))
    args = (indptr, col, q, k, v, mx, den, s_n, dy, 0.5, 0.2)
    before = ES.launches["k7"]
    ES._dot_bwd_dq_kernel(*args)
    ES._dot_bwd_dq_kernel(*args, raw)
    ES._dot_bwd_dq_kernel(*args, raw, layout=(1, 0, 4, 0))
    ES._dot_bwd_dq_kernel(*args, layout=(1, 0, 4, 0))
    vec = o % 4 == 0 and d % 4 == 0
    want = ES._dot_recv_layout(o // 4 if vec else o, d // 4 if vec else d,
                               16 if vec else 4, 40, 50, n_edges)
    calls = libs[False].calls + libs[True].calls
    assert [c[1][17:21] for c in calls] == [want, want, (1, 0, 4, 0),
                                            (1, 0, 4, 0)]
    assert [len(libs[False].calls), len(libs[True].calls)] == [2, 2]
    assert all(c[0] == "dot_bwd_dq_f32" for c in calls)
    assert all(c[1][12:17] == (50, heads, o, d, n_edges) for c in calls)
    assert [c[1][9] for c in calls] == [None, raw.data_ptr(),
                                        raw.data_ptr(), None]
    line = 8 if vec else 32
    so, sd = (-(-(w // 4 if vec else w) // line) for w in (o, d))
    assert heads * (1 + sd) * n_edges in allocs
    assert heads * (1 + sd + so) * n_edges in allocs
    assert ES.launches["k7"] == before + 4


def test_dot_plain_versions_take_the_raw_logits():
    """``dot_softmax_plain`` writes each edge's raw logit where asked, and
    ``dot_bwd_dq_plain`` from those raw logits gives what it gives
    recomputing them; with and without a slope."""
    indptr, col, q, k, v, dy, mx, den, s_n = (
        t.double() if t.is_floating_point() else t
        for t in _dot_inputs(2, 6, 4, seed=3))
    q = q[:50]
    rows = torch.repeat_interleave(torch.arange(50), torch.diff(indptr).long())
    want = 0.4 * (q[rows] * k[col.long()]).sum(-1)
    for slope in (None, 0.2):
        raw = torch.full((col.numel(), 2), float("nan"), dtype=torch.float64)
        ES.dot_softmax_plain(indptr, col, q, k, v, 0.4, slope, raw)
        torch.testing.assert_close(raw, want, rtol=1e-12, atol=1e-12)
        args = (indptr, col, q, k, v, mx, den, s_n, dy, 0.4, slope)
        torch.testing.assert_close(ES.dot_bwd_dq_plain(*args, raw),
                                   ES.dot_bwd_dq_plain(*args),
                                   rtol=1e-12, atol=1e-12)


def test_dot_attention_saves_the_raw_logits_for_dq(monkeypatch):
    """``DotAttentionFunction`` hands K7 the raw logits K6 wrote, and only
    when ``q`` needs a gradient; a wrong residual changes ``dq``, so K7
    reads it."""
    import graphneuralnetworks_tpu_torch as tgnn

    rng = np.random.default_rng(8)
    g = tgnn.graph(rng.integers(0, 30, 150), rng.integers(0, 30, 150),
                   num_nodes=30, device="cpu")
    seen = []
    bwd_dq = ES.dot_bwd_dq
    monkeypatch.setattr(ES, "dot_bwd_dq", lambda *a: seen.append(a[11])
                        or bwd_dq(*a))
    q, k, v = (torch.tensor(rng.standard_normal((30, 2, w)),
                            requires_grad=True) for w in (3, 3, 4))
    ES.dot_attention_nodes(g, q, k, v, 0.5, 0.2).sum().backward()
    (raw,) = seen
    rows = g.receivers.long()
    torch.testing.assert_close(
        raw, 0.5 * (q[rows] * k[g.col_r.long()]).sum(-1).detach(),
        rtol=1e-12, atol=1e-12)
    dq = q.grad.clone()
    monkeypatch.setattr(ES, "dot_bwd_dq", lambda *a: bwd_dq(
        *a[:11], a[11] + 1.0))
    q.grad = None
    ES.dot_attention_nodes(g, q, k, v, 0.5, 0.2).sum().backward()
    assert not torch.allclose(q.grad, dq)
    seen.clear()
    monkeypatch.setattr(ES, "dot_bwd_dq", lambda *a: seen.append(a)
                        or bwd_dq(*a))
    ES.dot_attention_nodes(g, q.detach(), k, v, 0.5).sum().backward()
    assert seen == []


# ---- on the card -----------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _groupings(seed, n_src=300, n_dst=260):
    """Edges from ``n_src`` senders to ``n_dst`` receivers (bipartite when
    they differ): 2,000 random ones among the first 200 of each side (the
    rest have no edges), receiver 5 and sender 9 with 1,100 more, receiver
    7 and sender 11 with 40 more; sorted by receiver. Returns the receiver
    CSR ``(indptr_r, col_r)`` (col: senders), the sender CSR ``(indptr_s,
    col_s, eid_s)`` (col: receivers) as int32 card tensors, and E."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, 200, 2000), rng.integers(0, 200, 1100),
                        np.full(1100, 9), rng.integers(0, 200, 40),
                        np.full(40, 11)])
    r = np.concatenate([rng.integers(0, 200, 2000), np.full(1100, 5),
                        rng.integers(0, 200, 1100), np.full(40, 7),
                        rng.integers(0, 200, 40)])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    by_s = np.argsort(s, kind="stable")

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")

    def indptr(ids, n):
        return np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])

    indptr_r, indptr_s = indptr(r, n_dst), indptr(s, n_src)
    return (t(indptr_r), t(s)), (t(indptr_s), t(r[by_s]), t(by_s)), len(s)


# Kernel and plain version sum a row in other orders. Over the row of
# 1,100 edges of unit-spread terms the partial sums s_k grow as sqrt(k) and
# each float32 addition rounds by up to eps / 2 * |s_k|: in the worst order
# the error is eps / 2 * sum_k |s_k| ~ 6e-8 * 0.55 * 1100^1.5 = 1.2e-3. Its
# typical size is far smaller (~1.4e-5 rms per side), but the tail is long:
# the largest of 512 columns reached 1.5e-4 in float32 simulations of two
# orders, and 3.0e-4 on an H100 (index_add_'s atomics against the
# kernel). So the rows are held to 1e-3 absolute, 1e-5 relative; a lost or
# doubled edge moves a sum by ~1.
TOL = dict(rtol=1e-5, atol=1e-3)


def _k1_layouts(fv):
    """Every K1 layout: each strip width up to the row's G and rows per
    warp the strip allows, at each unroll and register cap."""
    return [(rows, strip, u, cap) for strip in range(_log_g(fv) + 1)
            for rows in range(6 - strip) for u in (1, 2, 4, 8)
            for cap in (0, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 7, 8, 32, 128, 129, 512])
def test_spmm_layouts_on_card(d):
    """K1 at every layout and the default, weighted and unweighted, over
    the receiver CSR, the sender CSR with ``eid``, and ``col=None`` (the
    gather backward), against ``spmm_plain``; two runs give the same
    bits."""
    _needs_card()
    (ir, cr), (is_, cs, es), n_edges = _groupings(d, n_src=260)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(260, d, device="cuda", generator=gen)
    e = torch.randn(n_edges, d, device="cuda", generator=gen)
    w = torch.rand(n_edges, device="cuda", generator=gen) + 0.5
    fv = d // 4 if d % 4 == 0 else d
    for args in ((ir, cr, None, None, x), (ir, cr, None, w, x),
                 (is_, cs, es, None, x), (is_, cs, es, w, x),
                 (ir, None, None, None, e), (ir, None, None, w, e)):
        want = S.spmm_plain(*args)
        assert (want[200:] == 0).all()
        first = S.spmm_csr(*args)
        torch.testing.assert_close(first, want, **TOL)
        torch.testing.assert_close(S.spmm_csr(*args), first, rtol=0, atol=0)
        for lay in _k1_layouts(fv):
            torch.testing.assert_close(S._spmm_csr_kernel(*args, layout=lay),
                                       want, **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_spmm_refuses_a_layout_it_does_not_have():
    """A layout wider than a warp, an unroll or a register cap the kernel
    was not built for, a strip wider than the row's G or negative: the
    launch is refused, nothing runs."""
    _needs_card()
    (ir, cr), _, _ = _groupings(1)
    x = torch.randn(260, 8, device="cuda")
    for lay in ((5, 1, 1, 0), (0, 1, 3, 0), (0, 1, 1, 32), (1, 1, 0, 0),
                (0, 1, 0, 64), (0, 0, 0, 0), (0, 2, 1, 0), (0, -1, 1, 0)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            S._spmm_csr_kernel(ir, cr, None, None, x, layout=lay)


def _k8_layouts(ov, dv):
    """Every K8 layout of the sweep build: rows per warp, and (U, cap) with
    NC * U <= 4 (U = 1 always), a cap only for NC <= 2."""
    wide = max(ov, dv)
    nc = 1 << max(0, (wide - 1).bit_length() - 5)
    return [(rows, u, cap) for rows in range(6 - _log_g(wide))
            for u in (1, 2, 4) for cap in (0, 64)
            if (u == 1 or nc * u <= 4) and (cap == 0 or nc <= 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(1, 8, 8), (4, 32, 32), (1, 128, 128),
                                       (2, 4, 12), (3, 5, 7), (1, 256, 256)])
def test_dot_bwd_rev_layouts_on_card(heads, o, d):
    """K8 at every layout and the default, with and without a slope, over
    a bipartite sender CSR (300 senders, 260 receivers), against
    ``dot_bwd_rev_plain``; two runs give the same bits."""
    _needs_card()
    _, (is_, cs, _), _ = _groupings(heads * 100 + o + d)
    gen = torch.Generator(device="cuda").manual_seed(heads + o + d)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, dy = rn(260, heads, o), rn(260, heads, d)
    k, v = rn(300, heads, o), rn(300, heads, d)
    # logits of unit spread under a row max of 3 or more: alpha ~1 or
    # less, terms of unit spread as for K1 (TOL)
    mx, s_n = rn(260, heads).abs() + 3, rn(260, heads)
    den = torch.rand(260, heads, device="cuda", generator=gen) + 1
    vec = o % 4 == 0 and d % 4 == 0
    layouts = _k8_layouts(o // 4 if vec else o, d // 4 if vec else d)
    tol = TOL
    for slope in (None, 0.2):
        args = (is_, cs, q, k, v, mx, den, s_n, dy, o ** -0.5, slope)
        want = ES.dot_bwd_rev_plain(*args)
        assert (want[0][200:] == 0).all() and (want[1][200:] == 0).all()
        first = ES.dot_bwd_rev(*args)
        again = ES.dot_bwd_rev(*args)
        for a, b, c in zip(first, want, again):
            torch.testing.assert_close(a, b, **tol)
            torch.testing.assert_close(c, a, rtol=0, atol=0)
        for lay in layouts:
            for a, b in zip(ES._dot_bwd_rev_kernel(*args, layout=lay), want):
                torch.testing.assert_close(a, b, **tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 7, 8, 32, 128, 129, 512])
def test_spmm_sddmm_layouts_on_card(d):
    """K2 at every layout of the sweep build (K1's, :func:`_k1_layouts`,
    each by position and by edge id) and the default, weighted and
    unweighted, at one head (rows of ``[., D]``)
    and three (``[., 3, D]``), over a bipartite sender CSR (300 senders of
    260 receivers, empty rows, rows of 40 and 1,100 edges) with ``eid``,
    against ``spmm_sddmm_plain``; two runs of the default give the same
    bits."""
    _needs_card()
    _, (is_, cs, es), n_edges = _groupings(d + 7)
    gen = torch.Generator(device="cuda").manual_seed(d)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    fv = d // 4 if d % 4 == 0 else d
    for heads in (1, 3):
        shape = (d,) if heads == 1 else (heads, d)
        dy, x = rn(260, *shape), rn(300, *shape)
        w = torch.rand(n_edges, *shape[:-1], device="cuda",
                       generator=gen) + 0.5
        for ww in (w, None):
            args = (is_, cs, es, ww, dy, x)
            want = S.spmm_sddmm_plain(*args)
            assert (want[0][200:] == 0).all()
            first, again = S.spmm_sddmm(*args), S.spmm_sddmm(*args)
            for a, b, c in zip(first, want, again):
                torch.testing.assert_close(a, b, **TOL)
                torch.testing.assert_close(c, a, rtol=0, atol=0)
            for lay in _k1_layouts(fv):
                for by_position in (0, 1):
                    got = S._spmm_sddmm_kernel(*args,
                                               layout=lay + (by_position,))
                    for a, b in zip(got, want):
                        torch.testing.assert_close(a, b, **TOL)
    torch.cuda.synchronize()


def _bf16_close(got, want):
    """A bfloat16 kernel output against its plain version: each rounds one
    float32 sum (taken in another order: TOL's atol) to bfloat16, so the two
    may land one bfloat16 ulp apart."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    _, e = torch.frexp(w.abs().clamp(min=torch.finfo(torch.float32).tiny))
    ulp = torch.exp2(e.double() - 8)          # |w| in [2^(e-1), 2^e)
    err = (g - w).abs()
    assert bool((err <= ulp + TOL["atol"]).all()), float(
        (err / (ulp + TOL["atol"])).max())


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (1, 128), (2, 16), (4, 32),
                                     (4, 8), (4, 64), (4, 128), (3, 16)])
def test_spmm_sddmm_bf16_layouts_on_card(heads, d):
    """bfloat16 K2 at every layout of the sweep build: by edge id and by
    sender-CSR position at every strip of a line or more (modes 0, 1), and
    for 4 heads of a power of two of bf16x8 vectors, at most 32 of them
    together, the all-heads walk (mode 2); weighted and unweighted,
    over a bipartite sender CSR with empty rows and rows of 40 and 1,100
    edges, against ``spmm_sddmm_plain`` (dx, dw within one bfloat16 ulp);
    the chooser's layout twice, the same bits."""
    _needs_card()
    _, (is_, cs, es), n_edges = _groupings(heads * 10 + d)
    gen = torch.Generator(device="cuda").manual_seed(heads + d)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    shape = (d,) if heads == 1 else (heads, d)
    dy, x = rn(260, *shape), rn(300, *shape)
    w = rn(n_edges, *shape[:-1])
    fv, vec = S._row_vectors(d, 2, dy, x, w)
    assert vec == 16
    log_g = _log_g(fv)
    lays = [(r, strip, u, c, mode) for mode in (0, 1)
            for strip in range(min(log_g, 3), log_g + 1)
            for r in range(6 - strip) for u in (1, 2, 4, 8) for c in (0, 64)]
    walk = heads == 4 and fv & (fv - 1) == 0 and heads * fv <= 32
    if walk:
        lg = _log_g(heads * fv)
        lays += [(r, lg, u, c, 2) for r in range(6 - lg)
                 for u in (1, 2, 4, 8) for c in (0, 64)]
    for ww in (w, None):
        args = (is_, cs, es, ww, dy, x)
        want = S.spmm_sddmm_plain(*args)
        first, again = S.spmm_sddmm(*args), S.spmm_sddmm(*args)
        for a, b, c in zip(first, want, again):
            _bf16_close(a, b)
            assert torch.equal(a, c)
        for lay in lays:
            for a, b in zip(S._spmm_sddmm_kernel(*args, layout=lay), want):
                _bf16_close(a, b)
    chosen = S._spmm_sddmm_bf16_layout(fv, vec, 260, 300, n_edges, heads)
    assert chosen[4] == (2 if walk and heads * fv * 16 <= 256 else
                         int(heads > 1))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (1, 128, 128),
                                       (2, 64, 16), (1, 256, 256)])
def test_dot_bwd_dq_bf16_layouts_on_card(heads, o, d):
    """bfloat16 K7 at every layout of the sweep build on bf16x8 rows: the
    register kernel at every rows per warp and (edges in flight, register
    cap), strips of a line for heads wider than a line; from K6's raw
    logits and
    recomputing them, with and without a slope, over a bipartite receiver
    CSR with empty rows and rows of 40 and 1,100 edges, against
    ``dot_bwd_dq_plain`` (dq within one bfloat16 ulp); every rows layout
    the same bits as one edge at a time at the same rows per warp (the same
    sums in the same order)."""
    _needs_card()
    (ir, cr), _, n_edges = _groupings(heads * 100 + o + d)
    gen = torch.Generator(device="cuda").manual_seed(heads * o + d)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, dy = rn(260, heads, o).bfloat16(), rn(260, heads, d).bfloat16()
    k, v = rn(300, heads, o).bfloat16(), rn(300, heads, d).bfloat16()
    ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
    assert vec == 16
    wide = max(ov, dv)
    log_g = _log_g(wide)
    pairs = ([(u, c) for u in (1, 2, 4) for c in (0, 64)] if wide <= 32
             else [(1, 0)])
    rows = [(0, r) + p for r in range(6 - log_g) for p in pairs]
    strips = [(1, r, 4, 0) for r in range(3)] if wide > 8 else []
    for slope in (None, 0.2):
        raw = torch.empty(n_edges, heads, device="cuda")
        fwd = ES.dot_softmax_plain(ir, cr, q, k, v, o ** -0.5, slope, raw)
        out, mx, den = ES.finalize_softmax(*fwd, rn(260, heads),
                                           rn(260, heads, d).bfloat16())
        bwd = (ir, cr, q, k, v, mx, den, (out.float() * dy.float()).sum(-1),
               dy, o ** -0.5, slope)
        for given in (raw, None):
            want = ES.dot_bwd_dq_plain(*bwd, given)
            first = ES.dot_bwd_dq(*bwd, given)
            _bf16_close(first, want)
            assert torch.equal(ES.dot_bwd_dq(*bwd, given), first)
            base = {}
            for lay in rows + strips:
                got = ES._dot_bwd_dq_kernel(*bwd, given, lay)
                _bf16_close(got, want)
                if not lay[0]:
                    ref = base.setdefault(lay[1], got)
                    assert torch.equal(got, ref), lay
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o", [(1, 8), (4, 32), (1, 128), (2, 7)])
def test_gatv2_bwd_rev_layouts_on_card(heads, o):
    """K11 at every layout of the sweep build (K8's, :func:`_k8_layouts`,
    each with the receivers' scalars packed and not) and the default, over a bipartite sender CSR (300 senders of 260
    receivers, empty rows, rows of 40 and 1,100 edges), with the receivers'
    row max and denominator from the forward and ``a`` at Glorot's scale,
    against ``gatv2_bwd_rev_plain``; two runs of the default give the same
    bits."""
    _needs_card()
    (ir, cr), (is_, cs, _), _ = _groupings(heads * 100 + o)
    gen = torch.Generator(device="cuda").manual_seed(heads + o)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, dy, k = rn(260, heads, o), rn(260, heads, o), rn(300, heads, o)
    a = rn(o, heads) * (2.0 / (o + heads)) ** 0.5
    num, m, s = ES.gatv2_softmax_plain(ir, cr, q, k, a, 0.2)
    out, mx, den = ES.finalize_softmax(num, m, s, rn(260, heads),
                                       rn(260, heads, o))
    args = (is_, cs, q, k, a, mx, den, (out * dy).sum(-1), dy, 0.2)
    want = ES.gatv2_bwd_rev_plain(*args)
    assert (want[200:] == 0).all()
    first, again = ES.gatv2_bwd_rev(*args), ES.gatv2_bwd_rev(*args)
    torch.testing.assert_close(first, want, **TOL)
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    ov = o // 4 if o % 4 == 0 else o
    for lay in _k8_layouts(ov, ov):
        for packed in (0, 1):
            torch.testing.assert_close(
                ES._gatv2_bwd_rev_kernel(*args, layout=lay + (packed,)),
                want, **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o", [(1, 8), (4, 32), (1, 128), (2, 7),
                                     (1, 1024)])
def test_gatv2_bwd_dq_layouts_on_card(heads, o):
    """K10 at every layout of the sweep build (K8's, :func:`_k8_layouts`)
    and the default, over a bipartite receiver CSR (260 receivers of 300
    senders, empty rows, rows of 40 and 1,100 edges), with the receivers'
    row max and denominator from the forward and ``a`` at Glorot's scale,
    against ``gatv2_bwd_dq_plain``: ``dq`` in float32, ``da`` against the
    plain version in float64 (only the kernel's rounding counts); two runs
    of each layout give the same bits, ``da`` included."""
    _needs_card()
    (ir, cr), _, _ = _groupings(heads * 100 + o + 1)
    gen = torch.Generator(device="cuda").manual_seed(heads + o + 1)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, dy, k = rn(260, heads, o), rn(260, heads, o), rn(300, heads, o)
    a = rn(o, heads) * (2.0 / (o + heads)) ** 0.5
    num, m, s = ES.gatv2_softmax_plain(ir, cr, q, k, a, 0.2)
    out, mx, den = ES.finalize_softmax(num, m, s, rn(260, heads),
                                       rn(260, heads, o))
    args = (ir, cr, q, k, a, mx, den, (out * dy).sum(-1), dy, 0.2)
    dq_want = ES.gatv2_bwd_dq_plain(*args)[0]
    da_want = ES.gatv2_bwd_dq_plain(*(
        t.double() if torch.is_tensor(t) and t.is_floating_point() else t
        for t in args))[1]
    assert (dq_want[200:] == 0).all()
    ov = o // 4 if o % 4 == 0 else o
    for lay in [None] + _k8_layouts(ov, ov):
        first = ES._gatv2_bwd_dq_kernel(*args, layout=lay)
        again = ES._gatv2_bwd_dq_kernel(*args, layout=lay)
        torch.testing.assert_close(first[0], dq_want, **TOL)
        torch.testing.assert_close(first[1].double(), da_want, **TOL)
        for a_, b_ in zip(again, first):
            torch.testing.assert_close(a_, b_, rtol=0, atol=0)
    torch.cuda.synchronize()


def _k5_layouts(dv):
    """Every K5 layout of the sweep build: K8's (:func:`_k8_layouts`) for
    rows of up to 256 vectors (wider ones go in passes of 256), each with
    the receivers' scalars packed and not."""
    wide = min(dv, 256)
    return [lay + (packed,) for lay in _k8_layouts(wide, wide)
            for packed in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32), (1, 128), (2, 7),
                                     (1, 1100), (2, 300)])
def test_gat_bwd_rev_layouts_on_card(heads, d):
    """K5 at every layout of the sweep build (:func:`_k5_layouts`) and the
    default, over a bipartite sender CSR (300 senders of 260 receivers,
    empty rows, rows of 40 and 1,100 edges), with the receivers' row max
    and denominator from the forward, against ``gat_bwd_rev_plain``; (1,
    1100) takes two passes of 256 float4 vectors, (2, 300) scalar loads in
    two passes of 256; two runs of the default give the same bits."""
    _needs_card()
    (ir, cr), (is_, cs, _), _ = _groupings(heads * 100 + d + 2)
    gen = torch.Generator(device="cuda").manual_seed(heads + d + 2)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    pi, pj = rn(260, heads), rn(300, heads)
    v, dy = rn(300, heads, d), rn(260, heads, d)
    num, m, s = ES.gat_softmax_plain(ir, cr, pi, pj, v, 0.2)
    out, mx, den = ES.finalize_softmax(num, m, s, rn(260, heads),
                                       rn(260, heads, d))
    args = (is_, cs, pi, pj, v, mx, den, (out * dy).sum(-1), dy, 0.2)
    want = ES.gat_bwd_rev_plain(*args)
    assert (want[0][200:] == 0).all() and (want[1][200:] == 0).all()
    first, again = ES.gat_bwd_rev(*args), ES.gat_bwd_rev(*args)
    for a_, b_, c_ in zip(first, want, again):
        torch.testing.assert_close(a_, b_, **TOL)
        torch.testing.assert_close(c_, a_, rtol=0, atol=0)
    for lay in _k5_layouts(d // 4 if d % 4 == 0 else d):
        for a_, b_ in zip(ES._gat_bwd_rev_kernel(*args, layout=lay), want):
            torch.testing.assert_close(a_, b_, **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o", [(1, 8), (4, 32), (1, 128), (2, 7),
                                     (1, 1024)])
def test_gatv2_softmax_layouts_on_card(heads, o):
    """K9 at every layout of the sweep build (K8's, :func:`_k8_layouts`)
    and the default, over a bipartite receiver CSR (260 receivers of 300
    senders, empty rows, rows of 40 and 1,100 edges), with ``a`` at
    Glorot's scale, against ``gatv2_softmax_plain``: an empty row gets m =
    -inf, s = 0 and num = 0; two runs of each layout give the same bits."""
    _needs_card()
    (ir, cr), _, _ = _groupings(heads * 100 + o + 3)
    gen = torch.Generator(device="cuda").manual_seed(heads + o + 3)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, k = rn(260, heads, o), rn(300, heads, o)
    a = rn(o, heads) * (2.0 / (o + heads)) ** 0.5
    args = (ir, cr, q, k, a, 0.2)
    want = ES.gatv2_softmax_plain(*args)
    assert torch.isneginf(want[1][200:]).all()
    assert (want[2][200:] == 0).all() and (want[0][200:] == 0).all()
    ov = o // 4 if o % 4 == 0 else o
    for lay in [None] + _k8_layouts(ov, ov):
        first = ES._gatv2_softmax_kernel(*args, layout=lay)
        again = ES._gatv2_softmax_kernel(*args, layout=lay)
        for a_, b_, c_ in zip(first, want, again):
            torch.testing.assert_close(a_, b_, **TOL)
            torch.testing.assert_close(c_, a_, rtol=0, atol=0)
    torch.cuda.synchronize()


def _k3_layouts(dv):
    """Every K3 layout of the sweep build: K8's (:func:`_k8_layouts`) for
    rows of up to 256 vectors (wider ones go in passes of 256), each with
    pj loaded ahead by the lane holding the index and by every lane."""
    wide = min(dv, 256)
    return [lay + (ahead,) for lay in _k8_layouts(wide, wide)
            for ahead in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32), (1, 128), (2, 7),
                                     (1, 1024), (1, 1100), (2, 300)])
def test_gat_softmax_layouts_on_card(heads, d):
    """K3 at every layout of the sweep build (:func:`_k3_layouts`) and the
    default, over a bipartite receiver CSR (260 receivers of 300 senders,
    empty rows, rows of 40 and 1,100 edges), against
    ``gat_softmax_plain``; (1, 1100) takes two passes of 256 float4
    vectors, (2, 300) scalar loads in two passes of 256. Receiver 7 (a row
    of 40 edges and more) has pi = -inf, so all its logits are -inf, and
    sender 11 (40 edges and more) pj = -inf: those rows and the empty ones
    get m = -inf, s = 0 and num = 0; two runs of each layout give the same
    bits."""
    _needs_card()
    (ir, cr), _, _ = _groupings(heads * 100 + d + 4)
    gen = torch.Generator(device="cuda").manual_seed(heads + d + 4)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    pi, pj, v = rn(260, heads), rn(300, heads), rn(300, heads, d)
    pi[7], pj[11] = float("-inf"), float("-inf")
    args = (ir, cr, pi, pj, v, 0.2)
    want = ES.gat_softmax_plain(*args)
    for row in [7] + list(range(200, 260)):
        assert torch.isneginf(want[1][row]).all()
        assert (want[2][row] == 0).all() and (want[0][row] == 0).all()
    for lay in [None] + _k3_layouts(d // 4 if d % 4 == 0 else d):
        first = ES._gat_softmax_kernel(*args, layout=lay)
        again = ES._gat_softmax_kernel(*args, layout=lay)
        for a_, b_, c_ in zip(first, want, again):
            torch.testing.assert_close(a_, b_, **TOL)
            torch.testing.assert_close(c_, a_, rtol=0, atol=0)
    torch.cuda.synchronize()


def _k12_layouts(dv):
    """Every K12 layout of the sweep build: K8's (:func:`_k8_layouts`) for
    rows of up to 256 vectors (wider ones go in passes of 256), each with
    the heads one after the other and interleaved in the grid."""
    wide = min(max(dv, 1), 256)
    return [lay + (interleave,) for lay in _k8_layouts(wide, wide)
            for interleave in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32), (2, 7), (1, 1100),
                                     (2, 300)])
def test_edge_softmax_layouts_on_card(heads, d):
    """K12 at every layout of the sweep build (:func:`_k12_layouts`) and
    the default, over a bipartite receiver CSR (260 receivers of 300
    senders, empty rows, rows of 40 and 1,100 edges), with node values and
    without and with a dropout mask, and with edge values and a mask,
    against ``edge_softmax_plain``; (1, 1100) takes two passes of 256
    float4 vectors, (2, 7) scalar loads. The logits of receiver 7 (a row
    of 40 edges and more) are all -inf: it and the empty rows get m = -inf,
    s = 0 and num = 0; two runs of each layout give the same bits."""
    _needs_card()
    (ir, cr), _, n_edges = _groupings(heads * 100 + d + 5)
    gen = torch.Generator(device="cuda").manual_seed(heads + d + 5)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    lg = rn(n_edges, heads)
    lg[int(ir[7]):int(ir[8])] = float("-inf")
    mask = (torch.rand(n_edges, heads, device="cuda", generator=gen)
            < 0.4) / 0.4
    v, ve = rn(300, heads, d), rn(n_edges, heads, d)
    for args in ((ir, cr, lg, None, v), (ir, cr, lg, mask, v),
                 (ir, None, lg, mask, ve)):
        want = ES.edge_softmax_plain(*args)
        for row in [7] + list(range(200, 260)):
            assert torch.isneginf(want[1][row]).all()
            assert (want[2][row] == 0).all() and (want[0][row] == 0).all()
        for lay in [None] + _k12_layouts(d // 4 if d % 4 == 0 else d):
            first = ES._edge_softmax_kernel(*args, layout=lay)
            again = ES._edge_softmax_kernel(*args, layout=lay)
            for a_, b_, c_ in zip(first, want, again):
                torch.testing.assert_close(a_, b_, **TOL)
                torch.testing.assert_close(c_, a_, rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32), (2, 7), (1, 1100),
                                     (2, 300), (2, 0)])
def test_gat_bwd_dpi_layouts_on_card(heads, d):
    """K4 at every layout of the sweep build (K3's, :func:`_k3_layouts`)
    and the default, over a bipartite receiver CSR (260 receivers of 300
    senders, empty rows, rows of 40 and 1,100 edges), against
    ``gat_bwd_dpi_plain``, with the row max and denominator of the forward
    without self-loops: receiver 7 (a row of 40 edges and more) has pi =
    -inf, so it and the empty rows get mx = 0 and den = finfo.tiny, as
    ``finalize_softmax`` sets them, and dpi = 0. (1, 1100) takes two passes
    of 256 float4 vectors; D = 0 gives dpi = -sum_e w_e s_n; two runs of
    each layout give the same bits."""
    _needs_card()
    (ir, cr), _, _ = _groupings(heads * 100 + d + 6)
    gen = torch.Generator(device="cuda").manual_seed(heads + d + 6)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    pi, pj, v, dy = rn(260, heads), rn(300, heads), rn(300, heads, d), \
        rn(260, heads, d)
    pi[7] = float("-inf")
    out, mx, den = ES.finalize_softmax(
        *ES.gat_softmax_plain(ir, cr, pi, pj, v, 0.2))
    tiny = torch.finfo(torch.float32).tiny
    for row in [7] + list(range(200, 260)):
        assert (mx[row] == 0).all() and (den[row] == tiny).all()
    s_n = (out * dy).sum(-1) + rn(260, heads)
    args = (ir, cr, pi, pj, v, mx, den, s_n, dy, 0.2)
    want = ES.gat_bwd_dpi_plain(*args)
    assert (want[7] == 0).all() and (want[200:] == 0).all()
    assert (want[:200] != 0).any()
    for lay in [None] + _k3_layouts(max(d // 4 if d % 4 == 0 else d, 1)):
        first = ES._gat_bwd_dpi_kernel(*args, layout=lay)
        torch.testing.assert_close(first, want, **TOL)
        torch.testing.assert_close(ES._gat_bwd_dpi_kernel(*args, layout=lay),
                                   first, rtol=0, atol=0)
    torch.cuda.synchronize()


def _dot_recv_layouts(ov, dv, vec):
    """Every K6 and K7 layout of the sweep build: rows as K8's
    (:func:`_k8_layouts`), and strips of one line at each rows per warp the
    line allows, U in {1, 2, 4, 8}, uncapped and at 64 registers."""
    log_s = 3 if vec else 5
    return ([(0,) + lay for lay in _k8_layouts(ov, dv)]
            + [(1, rows, u, cap) for rows in range(6 - log_s)
               for u in (1, 2, 4, 8) for cap in (0, 64)])


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(1, 8, 8), (4, 32, 32), (1, 128, 128),
                                       (1, 256, 256), (3, 5, 7), (2, 64, 16)])
def test_dot_recv_layouts_on_card(heads, o, d):
    """K6 and K7 at every layout and the default, with and without a
    slope, K7 from K6's raw logits and recomputing them, over a bipartite
    receiver CSR (260 receivers of 300 senders, empty rows, rows of 40 and
    1,100 edges), against ``dot_softmax_plain`` and ``dot_bwd_dq_plain``;
    two runs of the default give the same bits."""
    _needs_card()
    (ir, cr), _, n_edges = _groupings(heads * 100 + o + d)
    gen = torch.Generator(device="cuda").manual_seed(heads * o + d)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, dy = rn(260, heads, o), rn(260, heads, d)
    k, v = rn(300, heads, o), rn(300, heads, d)
    vec = o % 4 == 0 and d % 4 == 0
    layouts = _dot_recv_layouts(o // 4 if vec else o, d // 4 if vec else d,
                                vec)
    for slope in (None, 0.2):
        args = (ir, cr, q, k, v, o ** -0.5, slope)
        raw_want = torch.empty(n_edges, heads, device="cuda")
        want = ES.dot_softmax_plain(*args, raw_want)
        assert torch.isneginf(want[1][200:]).all()
        assert (want[2][200:] == 0).all() and (want[0][200:] == 0).all()
        out, mx, den = ES.finalize_softmax(*want, rn(260, heads),
                                           rn(260, heads, d))
        bwd = (ir, cr, q, k, v, mx, den, (out * dy).sum(-1), dy, o ** -0.5,
               slope)
        dq_want = ES.dot_bwd_dq_plain(*bwd)
        raw = torch.empty_like(raw_want)
        first = ES.dot_softmax(*args, raw)
        again = ES.dot_softmax(*args)
        for a, b, c in zip(first, want, again):
            torch.testing.assert_close(a, b, **TOL)
            torch.testing.assert_close(c, a, rtol=0, atol=0)
        torch.testing.assert_close(raw, raw_want, rtol=1e-5, atol=1e-5)
        dq = ES.dot_bwd_dq(*bwd, raw)
        torch.testing.assert_close(dq, dq_want, **TOL)
        torch.testing.assert_close(ES.dot_bwd_dq(*bwd, raw), dq, rtol=0,
                                   atol=0)
        for lay in layouts:
            got_raw = torch.full_like(raw, float("nan"))
            got = ES._dot_softmax_kernel(*args, raw_out=got_raw, layout=lay)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, **TOL)
            torch.testing.assert_close(got_raw, raw_want, rtol=1e-5,
                                       atol=1e-5)
            for given in (raw, None):
                torch.testing.assert_close(
                    ES._dot_bwd_dq_kernel(*bwd, given, layout=lay), dq_want,
                    **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_shipped_build_holds_only_the_chosen_instances():
    """The shipped libraries launch the (unroll, reg_cap) pairs the
    choosers pick and refuse the sweep's others (nothing runs): K1 (2, 0)
    and (8, 64); K2 (2, 0) and (4, 64); K8 and K11 (2, 64) for rows of one
    register chunk, (1, 0) wider; K6, K7, K10, K5, K12 (with the heads
    interleaved or not) and K4 (with pj ahead or not) in rows (2, 64) and (4, 64)
    for rows of one register chunk, (1, 0) wider, and K6 and K7 in strips
    (4, 0); K9 (4, 64) and (2, 0), K3 (4, 64) and (1, 0) (each with pj
    ahead or not) for rows of one register chunk, (1, 0) wider."""
    _needs_card()
    (ir, cr), (is_, cs, _), _ = _groupings(2)
    x = torch.randn(260, 8, device="cuda")
    y = torch.empty_like(x)
    lib = S._lib()
    for (unroll, cap), ok in (((2, 0), True), ((8, 64), True),
                              ((1, 0), False), ((4, 64), False),
                              ((2, 64), False), ((8, 0), False)):
        code = S._call_on(x.device, lib.spmm_csr_f32, S._ptr(ir), S._ptr(cr),
                          None, None, S._ptr(x), S._ptr(y), 260, 8, 16, 0,
                          1, unroll, cap)
        assert (code == 0) == ok, (unroll, cap, code)
    xs, dys = torch.randn(300, 8, device="cuda"), torch.randn(260, 8,
                                                              device="cuda")
    dx, dw = torch.empty_like(xs), torch.empty(cs.numel(), device="cuda")
    for (unroll, cap), ok in (((2, 0), True), ((4, 64), True),
                              ((1, 0), False), ((8, 64), False),
                              ((2, 64), False), ((4, 0), False)):
        code = S._call_on(x.device, lib.spmm_sddmm_csr_f32,
                          *(S._ptr(t) for t in (is_, cs, None, None, dys, xs,
                                                dx, dw, None)),
                          300, 1, 8, cs.numel(), 16, 0, 1, unroll, cap, 0)
        assert (code == 0) == ok, ("k2", unroll, cap, code)
    for o, (unroll, cap), ok in ((8, (2, 64), True), (8, (1, 0), False),
                                 (8, (4, 64), False), (256, (1, 0), True),
                                 (256, (2, 64), False), (256, (1, 64), False)):
        q, k, v, dy = (torch.randn(n, 1, o, device="cuda")
                       for n in (260, 300, 300, 260))
        mx, den, s_n = (torch.randn(260, 1, device="cuda") for _ in range(3))
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        code = S._call_on(
            x.device, ES._lib().dot_bwd_rev_f32,
            *(S._ptr(t) for t in (is_, cs, q, k, v, mx, den, s_n, dy, dk,
                                  dv)), 300, 1, o, o, 0, unroll, cap, 0.5,
            0.0)
        assert (code == 0) == ok, (o, unroll, cap, code)
        a = torch.randn(o, 1, device="cuda")
        code = S._call_on(
            x.device, ES._lib().gatv2_bwd_rev_f32,
            *(S._ptr(t) for t in (is_, cs, dy, k, a, mx, den, s_n, None, dy,
                                  dk)),
            300, 1, o, 0, unroll, cap, 0.2)
        assert (code == 0) == ok, ("k11", o, unroll, cap, code)
    for o, (unroll, cap), ok in ((8, (2, 64), True), (8, (4, 64), True),
                                 (8, (1, 0), False), (8, (4, 0), False),
                                 (256, (1, 0), True), (256, (2, 64), False)):
        q, k, v, dy = (torch.randn(n, 1, o, device="cuda")
                       for n in (260, 300, 300, 260))
        mx, den, s_n = (torch.randn(260, 1, device="cuda") for _ in range(3))
        a = torch.randn(o, 1, device="cuda")
        dq, dv = torch.empty_like(q), torch.empty_like(v)
        part = torch.empty(o * ES._dq_blocks(260, 0), device="cuda")
        code = S._call_on(
            x.device, ES._lib().gatv2_bwd_dq_f32,
            *(S._ptr(t) for t in (ir, cr, q, k, a, mx, den, s_n, dy, dq,
                                  part)),
            260, 1, o, 0, unroll, cap, 0.2)
        assert (code == 0) == ok, ("k10", o, unroll, cap, code)
        pj, dpj = torch.randn(300, 1, device="cuda"), torch.empty(
            300, 1, device="cuda")
        code = S._call_on(
            x.device, ES._lib().gat_bwd_rev_f32,
            *(S._ptr(t) for t in (is_, cs, mx, pj, v, mx, den, s_n, None, dy,
                                  dpj, dv)),
            300, 1, o, 0, unroll, cap, 0.2)
        assert (code == 0) == ok, ("k5", o, unroll, cap, code)
        lg, num = torch.randn(cr.numel(), 1, device="cuda"), torch.empty_like(
            q)
        m, s = torch.empty_like(mx), torch.empty_like(mx)
        for interleave in (0, 1):
            code = S._call_on(
                x.device, ES._lib().edge_softmax_f32,
                *(S._ptr(t) for t in (ir, cr, lg, lg, v, num, m, s)),
                260, 1, o, 0, unroll, cap, interleave)
            assert (code == 0) == ok, ("k12", o, unroll, cap, code)
        for ahead in (0, 1):
            code = S._call_on(
                x.device, ES._lib().gat_bwd_dpi_f32,
                *(S._ptr(t) for t in (ir, cr, mx, pj, v, mx, den, s_n, dy,
                                      dpj)),
                260, 1, o, 0, unroll, cap, ahead, 0.2)
            assert (code == 0) == ok, ("k4", o, unroll, cap, ahead, code)
    for o, (unroll, cap), k9_ok, k3_ok in (
            (8, (4, 64), True, True), (8, (2, 0), True, False),
            (8, (1, 0), False, True), (8, (2, 64), False, False),
            (8, (4, 0), False, False), (256, (1, 0), True, True),
            (256, (2, 64), False, False), (256, (1, 64), False, False)):
        q, k, v = (torch.randn(n, 1, o, device="cuda")
                   for n in (260, 300, 300))
        pi, pj = torch.randn(260, 1, device="cuda"), torch.randn(
            300, 1, device="cuda")
        a = torch.randn(o, 1, device="cuda")
        num, m, s = torch.empty_like(q), torch.empty_like(pi), \
            torch.empty_like(pi)
        code = S._call_on(
            x.device, ES._lib().gatv2_softmax_f32,
            *(S._ptr(t) for t in (ir, cr, q, k, a, num, m, s)),
            260, 1, o, 0, unroll, cap, 0.2)
        assert (code == 0) == k9_ok, ("k9", o, unroll, cap, code)
        for ahead in (0, 1):
            code = S._call_on(
                x.device, ES._lib().gat_softmax_f32,
                *(S._ptr(t) for t in (ir, cr, pi, pj, v, num, m, s)),
                260, 1, o, 0, unroll, cap, ahead, 0.2)
            assert (code == 0) == k3_ok, ("k3", o, unroll, cap, ahead, code)
    n_edges = cr.numel()
    raw = torch.randn(n_edges, 1, device="cuda")
    for o, (strips, unroll, cap), ok in (
            (8, (0, 2, 64), True), (8, (0, 4, 64), True),
            (8, (0, 1, 0), False), (8, (0, 4, 0), False),
            (256, (0, 1, 0), True), (256, (0, 2, 64), False),
            (128, (1, 4, 0), True), (128, (1, 8, 64), False),
            (128, (1, 4, 64), False), (128, (1, 1, 0), False)):
        q, dy = (torch.randn(260, 1, o, device="cuda") for _ in range(2))
        k, v = (torch.randn(300, 1, o, device="cuda") for _ in range(2))
        mx, den, s_n = (torch.randn(260, 1, device="cuda") for _ in range(3))
        num, dq = torch.empty_like(q), torch.empty_like(q)
        m, s = torch.empty_like(mx), torch.empty_like(mx)
        scratch = torch.empty(8 * n_edges, device="cuda")
        code = S._call_on(
            x.device, ES._lib().dot_softmax_f32,
            *(S._ptr(t) for t in (ir, cr, q, k, v, num, m, s, raw, scratch)),
            260, 1, o, o, n_edges, strips, 0, unroll, cap, 0.5, 1.0)
        assert (code == 0) == ok, ("k6", o, strips, unroll, cap, code)
        code = S._call_on(
            x.device, ES._lib().dot_bwd_dq_f32,
            *(S._ptr(t) for t in (ir, cr, q, k, v, mx, den, s_n, dy, raw, dq,
                                  scratch)),
            260, 1, o, o, n_edges, strips, 0, unroll, cap, 0.5, 1.0)
        assert (code == 0) == ok, ("k7", o, strips, unroll, cap, code)
    torch.cuda.synchronize()
