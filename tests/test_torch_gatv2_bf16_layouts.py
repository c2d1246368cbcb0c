"""bfloat16 K11's layouts of its own: ``_gatv2_bwd_rev_bf16_layout`` by
vector width (``ops/cuda/edge_softmax.py``'s ``_K11_BF16``), every layout
it returns one the shipped library builds (``csrc/edge_softmax.cu``'s
picks, read from the source), and the wrapper's launches: the layout and
the receivers' scalars packed as one float4, through a stand-in library
that runs the plain version on CPU tensors (the kernels have no CPU mode);
and (``gpu``-marked) every layout of the sweep build on the card against
``gatv2_bwd_rev_plain``.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest tests/test_torch_gatv2_bf16_layouts.py --noconftest -o addopts="" -m gpu
"""

import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402

SOURCE = (Path(ES.__file__).resolve().parents[2] / "csrc"
          / "edge_softmax.cu").read_text()
MEAN_ROW_LENGTHS = [0, 0.5, 1, 3, 15.26, 100, 2048]
N, E = 131_072, 2_000_000


def _pick_body(name):
    return re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)


# (edges a stage, stages, register cap) of each staged K11 instance the
# shipped library holds at one register chunk (K11StagedPick), and past one
# chunk (with_staged_instances: one edge, two stages, uncapped)
K11_STAGED = {tuple(int(x) for x in m) for m in re.findall(
    r"u == (\d+) && ns == (\d+) && cap == (\d+)", _pick_body("K11StagedPick"))}
WIDE_STAGED = (1, 2, 0)
# the register instances of K11 (K11Pick: one register chunk, wider rows),
# and whether the shipped library holds them for bf16x8 rows
# (K11RegisterPick)
_K11 = re.search(r"nc == 1 \? u == (\d+) && cap == (\d+)\s*: u == (\d+) && "
                 r"cap == (\d+)", _pick_body("K11Pick")).groups()
K11_REGISTER, WIDE_REGISTER = ((int(_K11[0]), int(_K11[1])),
                               (int(_K11[2]), int(_K11[3])))
REGISTER_ON_BF16X8 = "NoPick" not in re.search(
    r"using K11RegisterPick =(.*?);", SOURCE, re.S).group(1)


def _log_g(vectors):
    return min((vectors - 1).bit_length(), 5)


def test_picks_read_from_the_source():
    """The picks the tests below read from the source name at least one
    staged instance, with at least two stages, and K11Pick's two register
    pairs (float32's ``_K11_UNROLL`` and ``_K11_REG_CAP``)."""
    assert K11_STAGED and all(ns >= 2 and cap in (0, 64)
                              for _, ns, cap in K11_STAGED)
    assert K11_REGISTER == (ES._K11_UNROLL, ES._K11_REG_CAP)
    assert WIDE_REGISTER == (1, 0)


def _widths():
    """``(o, widest vector bytes, vectors)`` for bfloat16 heads of 1 to 300
    values and a few wider, in each vector they may take, at most 256
    vectors."""
    for o in list(range(1, 301)) + [512, 1024, 2048]:
        for vec in (16, 8, 2):
            per = vec // 2
            if o % per == 0 and o // per <= 256:
                yield o, vec, o // per


def _check(lay, vec, ov):
    """A bfloat16 K11 layout ``(log_rows, unroll, reg_cap, packed,
    stages)`` is one the shipped library builds."""
    log_rows, unroll, cap, packed, stages = lay
    assert 0 <= log_rows <= 5 - _log_g(ov)
    if stages:
        assert vec == 16 and packed == (2 if ov == 1 else 1)
        assert ((unroll, stages, cap) in K11_STAGED if ov <= 32
                else (unroll, stages, cap) == WIDE_STAGED)
    else:
        assert vec < 16 or REGISTER_ON_BF16X8
        assert (unroll, cap) == (K11_REGISTER if ov <= 32 else WIDE_REGISTER)
        assert packed == int(vec << _log_g(ov) < ES._K11_PACK_BELOW)


@pytest.mark.parametrize("n_rows,mean", [(0, 0)] + [
    (N, m) for m in MEAN_ROW_LENGTHS])
def test_k11_bf16_layouts_are_built(n_rows, mean):
    """bfloat16 K11's chooser gives, for every width and vector and at each
    mean row length (an empty graph too), a layout of the shipped library:
    on bf16x8 rows its table's (a staged instance of K11StagedPick, past
    32 vectors a row the wide one, the scalars packed), on 8-byte vectors
    or single values float32's rule (the register kernel at K11Pick's
    pairs); R rows of G lanes fit a warp."""
    entries = round(mean * n_rows)
    for o, vec, ov in _widths():
        lay = ES._gatv2_bwd_rev_bf16_layout(ov, vec, n_rows, entries)
        _check(lay, vec, ov)
        if vec < 16:
            assert lay == ES._gatv2_bwd_rev_layout(ov, vec, n_rows,
                                                   entries) + (0,)


def test_k11_bf16_table_is_built():
    """Each entry of ``_K11_BF16`` names an instance the shipped library
    holds: staged ones of K11StagedPick at one register chunk (rows of at
    most 512 bytes) and the wide one past it; its last entry covers the
    widest rows (256 bf16x8 vectors)."""
    assert ES._K11_BF16[-1][0] >= 256 * 16
    for most, (unroll, cap, stages, windows) in ES._K11_BF16:
        assert windows > 0
        if stages:
            assert ((unroll, stages, cap) in K11_STAGED if most <= 512
                    else (unroll, stages, cap) == WIDE_STAGED)
        else:
            assert REGISTER_ON_BF16X8 and (unroll, cap) == (
                K11_REGISTER if most <= 512 else WIDE_REGISTER)


@pytest.mark.parametrize("o,vec,want,f32", [
    # GATv2 layer 1 (H=4, O=32): 64-byte rows, 4 lanes of bf16x8; staged,
    # 2 edges a stage, 8 rows a warp
    (32, 16, (3, 2, 0, 1, 2), (2, 2, 64, 1)),
    # its head layer (H=1, O=8): 16-byte rows, one bf16x8 lane a group;
    # staged, one edge a stage, q and the scalars in one record, 8 rows a
    # warp
    (8, 16, (3, 1, 0, 2, 2), (2, 2, 64, 1)),
    # two register chunks (O=264: 33 vectors): staged, one edge, two stages
    (264, 16, (0, 1, 0, 1, 2), (0, 1, 0, 0)),
    # rows of 8-byte vectors at most: float32's rule, the register kernel
    (12, 8, (2, 2, 64, 1, 0), (2, 2, 64, 1)),
    # single values: the same
    (7, 2, (2, 2, 64, 1, 0), (2, 2, 64, 1)),
])
def test_k11_bf16_layouts_at_the_measured_shapes(o, vec, want, f32):
    """At N = 131,072 senders and receivers, E = 2M, the layouts bfloat16
    K11's table gives by vector width (chip_smoke.py --sweep bf16_k11,
    PERF.md §6), and float32's chooser at the same vectors (what bfloat16
    K11 took before) unchanged."""
    ov = o // (vec // 2)
    assert ES._gatv2_bwd_rev_bf16_layout(ov, vec, N, E) == want
    assert ES._gatv2_bwd_rev_layout(ov, vec, N, E) == f32


# ---- the wrapper's launches, through a stand-in library ------------------

class _PlainLib:
    """Stands in for the kernel library on CPU tensors (``_ptr`` passes
    the tensors themselves): checks each call's layout integers as
    ``gatv2_bwd_rev_bf16`` takes them (the staged kernel on bf16x8 rows
    with the packed scalars) and computes the plain version into ``dk``,
    the receivers' scalars read from the packed ``stats`` where given."""

    def __init__(self):
        self.calls = []

    def gatv2_bwd_rev_bf16(self, indptr, col, q, k, a, mx, den, s_n, stats,
                           dy, dk, n_rows, heads, d, log_rows, unroll,
                           reg_cap, packed, stages, slope, stream):
        self.calls.append(((log_rows, unroll, reg_cap, packed, stages),
                           stats))
        assert a.dtype == torch.float32
        assert (stats is None) == (packed == 0)
        if stages:
            assert d % 8 == 0 and packed
        if packed == 2:   # q's row and the scalars in one 32-byte record
            assert stages and d == 8 and stats.shape == mx.shape + (8,)
            assert torch.equal(stats[..., :4].contiguous().view(
                torch.bfloat16), q)
            stats = stats[..., 4:]
        if stats is not None:
            assert stats.dtype == torch.float32
            assert stats.shape == mx.shape + (4,)
            mx, den, s_n = stats[..., 0], stats[..., 1], stats[..., 2]
        dk.copy_(ES.gatv2_bwd_rev_plain(indptr, col, q, k, a, mx, den, s_n,
                                        dy, slope))
        return 0


@pytest.fixture
def plain_lib(monkeypatch):
    lib = _PlainLib()
    monkeypatch.setattr(ES, "_lib", lambda sweep=False: lib)
    monkeypatch.setattr(ES, "_ptr", lambda t: t)
    monkeypatch.setattr(ES, "_call_on", lambda device, fn, *a: fn(*a, None))
    return lib


def _inputs(heads, o, seed):
    """A sender CSR of 40 senders (every 7th without edges) into 50
    receivers, bfloat16 q, dy (receivers'), k (senders') and a, float32
    mx, den, s_n."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, 40)
    counts[::7] = 0
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    col = torch.tensor(rng.integers(0, 50, int(indptr[-1])),
                       dtype=torch.int32)

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).bfloat16()

    def f32(values):
        return torch.tensor(values, dtype=torch.float32)

    return (indptr, col, bf(50, heads, o), bf(40, heads, o),
            bf(o, heads) * (2.0 / (o + heads)) ** 0.5,
            f32(rng.standard_normal((50, heads)) + 3),
            f32(rng.uniform(1, 3, (50, heads))),
            f32(rng.standard_normal((50, heads))), bf(50, heads, o), 0.2)


@pytest.mark.parametrize("heads,o", [(4, 32), (1, 8), (2, 12), (1, 264),
                                     (1, 7)])
def test_packed_k11_route_gives_the_unpacked_answers(plain_lib, heads, o):
    """``_gatv2_bwd_rev_kernel`` on bfloat16 CPU tensors, through its
    checks, its layout and the packing of the receivers' ``(mx, den,
    s_n)`` into ``[rows, H, 4]`` float32 (staged layouts and packed
    register ones; none for the others) or, with one bf16x8 vector a row,
    with ``q``'s row into ``[rows, H, 8]`` records (packed 2), at the
    chooser's layout (recorded in ``last_layout``), at staged layouts where
    the rows take bf16x8 and at register ones, packed or not (a
    four-integer layout is stages 0): the same bits as the plain version on
    the unpacked scalars."""
    args = _inputs(heads, o, heads + o)
    indptr, col, q, k, a, mx, den, s_n, dy, slope = args
    want = ES.gatv2_bwd_rev_plain(*args)
    fv, vec = ES._row_vectors(o, 2, q, k, dy)
    layouts = ([None] + [(0, 1, 0, 1, 2)] * (vec == 16)
               + [(0, 2, 0, 2, 4)] * (vec == 16 and fv == 1)
               + [(1, 2, 64, 0, 0), (1, 2, 64, 1)])
    before = ES.launches["k11_bf16"]
    for lay in layouts:
        got = ES._gatv2_bwd_rev_kernel(*args, layout=lay)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    chosen = ES._gatv2_bwd_rev_bf16_layout(fv, vec, 40, col.numel())
    assert plain_lib.calls[0][0] == chosen
    assert bool(chosen[4]) == (vec == 16)
    assert chosen[3] == (2 if vec == 16 and fv == 1 else 1)
    assert ES.last_layout["k11_bf16"] == (1, 2, 64, 1)
    for lay, (passed, stats) in zip(layouts, plain_lib.calls):
        lay = chosen if lay is None else lay
        assert passed == lay[:4] + ((lay[4],) if len(lay) > 4 else (0,))
        assert (stats is not None) == bool(lay[3])
        if stats is not None:
            assert torch.equal(stats[..., -4:-1],
                               torch.stack((mx, den, s_n), -1))
    assert ES.launches["k11_bf16"] == before + len(layouts)


def test_f32_k11_route_takes_no_stages(monkeypatch):
    """float32 K11 keeps its four-integer layout and the library call
    without a stages argument; the wrapper records it under ``k11``."""
    calls = []

    class _Lib:
        def gatv2_bwd_rev_f32(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(ES, "_lib", lambda sweep=False: _Lib())
    monkeypatch.setattr(ES, "_ptr", lambda t: t)
    monkeypatch.setattr(ES, "_call_on", lambda device, fn, *a: fn(*a, None))
    args = tuple(t.float() if torch.is_tensor(t) and t.is_floating_point()
                 else t for t in _inputs(4, 32, 1))
    ES._gatv2_bwd_rev_kernel(*args)
    (call,) = calls
    want = ES._gatv2_bwd_rev_layout(8, 16, 40, args[1].numel())
    assert call[14:17] == want[:3] and len(call) == 19
    assert ES.last_layout["k11"] == want


# ---- on the card -----------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _groupings(seed, n_src=300, n_dst=260):
    """A bipartite sender CSR (``indptr_s``, ``col_s``: receivers) and the
    receiver CSR of the same edges, int32 card tensors: 2,000 random edges
    among the first 200 of each side (the rest have none), sender 9 with
    1,100 more and sender 11 with 40 more, receiver 5 with 1,100 more and
    receiver 7 with 40 more; sorted by receiver."""
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

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device="cuda")

    def indptr(ids, n):
        return np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])

    return ((t(indptr(r, n_dst)), t(s)),
            (t(indptr(s, n_src)), t(r[by_s])))


def _bf16_close(got, want, atol=1e-3):
    """dk against its plain version: each rounds one float32 sum (taken in
    another order: ``atol``, as the float32 card tests' 1e-3 over rows of
    1,100 edges) to bfloat16, so the two may land one bfloat16 ulp
    apart."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    _, e = torch.frexp(w.abs().clamp(min=torch.finfo(torch.float32).tiny))
    ulp = torch.exp2(e.double() - 8)          # |w| in [2^(e-1), 2^e)
    err = (g - w).abs()
    assert bool((err <= ulp + atol).all()), float((err / (ulp + atol)).max())


def _sweep_layouts(ov):
    """Every bfloat16 K11 layout of the sweep build on bf16x8 rows of
    ``ov`` vectors: every rows per warp; at one register chunk the
    register kernel at every (edges in flight, register cap) of {1, 2, 4}
    x {0, 64}, packed or not, and the staged one at every (edges a stage,
    register cap, stages) of {1, 2} x {0, 64} x {2, 4, 6}, its scalars
    packed (and at one vector a row with ``q`` in one record too, packed
    2); wider rows the staged one at one edge, two stages, uncapped."""
    rows = range(6 - _log_g(ov))
    if ov > 32:
        return [(r, 1, 0, 1, 2) for r in rows]
    return ([(r, u, c, p, 0) for r in rows for u in (1, 2, 4)
             for c in (0, 64) for p in (0, 1)]
            + [(r, u, c, p, ns) for r in rows for u in (1, 2)
               for c in (0, 64) for ns in (2, 4, 6)
               for p in ((1, 2) if ov == 1 else (1,))])


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o", [(1, 8), (4, 32), (2, 64), (1, 256),
                                     (1, 264)])
def test_gatv2_bwd_rev_bf16_layouts_on_card(heads, o):
    """bfloat16 K11 at every layout of the sweep build on bf16x8 rows
    (:func:`_sweep_layouts`: the register and the staged kernel; (1, 264)
    two register chunks) and the chooser's, over a bipartite sender CSR
    (300 senders of 260 receivers, empty rows, rows of 40 and 1,100 edges)
    with the receivers' row max and denominator from the plain forward and
    ``a`` at Glorot's scale, against ``gatv2_bwd_rev_plain`` (within one
    bfloat16 ulp); the chooser's layout twice, the same bits; the staged
    layouts of one rows per warp the same bits as each other (the same sums
    in the same order), the record's too."""
    _needs_card()
    (ir, cr), (is_, cs) = _groupings(heads * 100 + o)
    gen = torch.Generator(device="cuda").manual_seed(heads + o)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).bfloat16()

    q, dy, k = rn(260, heads, o), rn(260, heads, o), rn(300, heads, o)
    a = rn(o, heads, scale=(2.0 / (o + heads)) ** 0.5)
    num, m, s = ES.gatv2_softmax_plain(ir, cr, q, k, a, 0.2)
    out, mx, den = ES.finalize_softmax(num, m, s, rn(260, heads),
                                       rn(260, heads, o))
    args = (is_, cs, q, k, a, mx, den, (out.float() * dy.float()).sum(-1),
            dy, 0.2)
    want = ES.gatv2_bwd_rev_plain(*args)
    assert (want[200:] == 0).all()
    first, again = ES.gatv2_bwd_rev(*args), ES.gatv2_bwd_rev(*args)
    _bf16_close(first, want)
    assert torch.equal(again, first)
    fv, vec = ES._row_vectors(o, 2, q, k, dy)
    assert vec == 16
    staged = {}
    for lay in _sweep_layouts(fv):
        got = ES._gatv2_bwd_rev_kernel(*args, layout=lay)
        _bf16_close(got, want)
        if lay[4]:
            assert torch.equal(got, staged.setdefault(lay[0], got)), lay
    torch.cuda.synchronize()
