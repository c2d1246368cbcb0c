"""The kernels' wrappers and plain versions (no JAX needed): SpMM (K1, K2),
edge softmax (K3, K4, K5, K12; GATv2's K9, K10, K11; dot attention's K6,
K7, K8), the per-edge dot (K13) and the segment max (K14 and its
backward); every one (and K14's backward) also on bfloat16.

- The plain versions (the CPU path, and the reference the CUDA kernels are
  held to) against a dense adjacency product or per-edge loops in float64.
- The wrappers' input checks, and the dispatch rule: CPU tensors take the
  plain version, CUDA tensors the kernel, anything else raises.
- ``gpu``-marked: the CUDA kernels against the plain versions on the card
  (K1 also through a hetero relation's graph, whose source and
  destination types differ in size, and a HeteroGraphConv step against
  the CPU).
  This file imports no JAX, so on a machine with a card and no JAX it runs
  without the suite's conftest:

      python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -m gpu
"""

import copy

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402

SLOPE = 0.2


def _graph(seed, device, dtype=torch.float64):
    """Directed multigraph on 50 nodes, the last 10 isolated, weighted."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, 40, 160), rng.integers(0, 40, 160)
    w = torch.tensor(rng.random(160) + 0.5, dtype=dtype)
    return tgnn.graph(s, r, num_nodes=50, edge_weight=w, device=device)


def test_plain_versions_match_dense():
    g = _graph(4, "cpu")
    n = g.num_nodes
    rng = np.random.default_rng(2)
    x, dy = rng.standard_normal((n, 6)), rng.standard_normal((n, 6))
    ws, ss, rs = g.edge_weight.numpy(), g.senders.numpy(), g.receivers.numpy()
    A = np.zeros((n, n))
    np.add.at(A, (rs, ss), ws)
    tol = dict(rtol=1e-12, atol=1e-12)
    y = S.spmm_plain(g.indptr_r, g.col_r, None, g.edge_weight,
                     torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), A @ x, **tol)
    dx = S.spmm_plain(g.indptr_s, g.col_s, g.eid_s, g.edge_weight,
                      torch.tensor(dy))
    np.testing.assert_allclose(dx.numpy(), A.T @ dy, **tol)
    dx2, dw = S.spmm_sddmm_plain(g.indptr_s, g.col_s, g.eid_s,
                                 g.edge_weight, torch.tensor(dy),
                                 torch.tensor(x))
    np.testing.assert_allclose(dx2.numpy(), A.T @ dy, **tol)
    np.testing.assert_allclose(dw.numpy(), np.sum(dy[rs] * x[ss], -1), **tol)
    # col=None reads rows in grouping order: the gather backward
    e = rng.standard_normal((g.num_edges, 3))
    want = np.zeros((n, 3))
    np.add.at(want, rs, e)
    got = S.spmm_plain(g.indptr_r, None, None, None, torch.tensor(e))
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_kernel_wrappers_validate_inputs():
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    x = torch.randn(16, 4)
    with pytest.raises(TypeError):
        S._check_launch(g.indptr_r, g.col_r, None, None, x.double())
    with pytest.raises(TypeError):
        S._check_launch(g.indptr_r, g.col_r.long(), None, None, x)
    with pytest.raises(ValueError):
        S._check_launch(g.indptr_r, g.col_r, None, None, x.t())
    S._check_launch(g.indptr_r, g.col_r, g.eid_s, torch.ones(40), x)
    # a tensor neither on the CPU nor on a CUDA card has no route
    with pytest.raises(ValueError):
        S.spmm_csr(g.indptr_r, g.col_r, None, None,
                   torch.empty(16, 4, device="meta"))


def test_cpu_tensors_launch_nothing():
    g = _graph(5, "cpu", torch.float32)
    x = torch.randn(g.num_nodes, 8, requires_grad=True)
    w = g.edge_weight.clone().requires_grad_()
    before = dict(S.launches)
    y = tgnn.ops.propagate(tgnn.ops.e_mul_xj, g, "sum", xj=x, e=w)
    y.sum().backward()
    assert S.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 8, 64, 128, 200])
def test_kernels_match_plain_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(6, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(g.num_nodes, d, device="cuda", generator=gen)
    dy = torch.randn(g.num_nodes, d, device="cuda", generator=gen)
    e = torch.randn(g.num_edges, d, device="cuda", generator=gen)
    before = dict(S.launches)
    for args in ((g.indptr_r, g.col_r, None, None, x),
                 (g.indptr_r, g.col_r, None, g.edge_weight, x),
                 (g.indptr_s, g.col_s, g.eid_s, g.edge_weight, dy),
                 (g.indptr_r, None, None, None, e)):
        torch.testing.assert_close(S.spmm_csr(*args), S.spmm_plain(*args),
                                   rtol=1e-5, atol=1e-5)
    args = (g.indptr_s, g.col_s, g.eid_s, g.edge_weight, dy, x)
    for a, b in zip(S.spmm_sddmm(*args), S.spmm_sddmm_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert S.launches["k1"] == before["k1"] + 4
    assert S.launches["k2"] == before["k2"] + 1


def test_edge_softmax_wrappers_validate_inputs():
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    pi, v = torch.randn(16, 2), torch.randn(16, 2, 4)
    with pytest.raises(TypeError):
        ES._check_launch(g.indptr_r, g.col_r, {"pi": pi.double()},
                         {"v": v})
    with pytest.raises(TypeError):
        ES._check_launch(g.indptr_r, g.col_r.long(), {"pi": pi}, {"v": v})
    with pytest.raises(ValueError):        # heads disagree
        ES._check_launch(g.indptr_r, g.col_r, {"pi": torch.randn(16, 3)},
                         {"v": v})
    with pytest.raises(ValueError):        # widths disagree
        ES._check_launch(g.indptr_r, g.col_r, {"pi": pi},
                         {"v": v, "dy": torch.randn(16, 2, 5)})
    with pytest.raises(ValueError):        # not [rows, H, D]
        ES._check_launch(g.indptr_r, g.col_r, {"pi": pi},
                         {"v": torch.randn(16, 8)})
    with pytest.raises(ValueError):
        ES._check_launch(g.indptr_r, g.col_r, {"pi": pi},
                         {"v": v.transpose(0, 1)})
    ES._check_launch(g.indptr_r, None, {"pi": pi, "mask": None}, {"v": v})
    with pytest.raises(ValueError):        # a row count that does not fit
        ES._same_rows(16, pi=pi, pj=torch.randn(15, 2))
    with pytest.raises(ValueError):        # no route for a meta tensor
        ES.gat_softmax(g.indptr_r, g.col_r, pi, pi,
                       torch.empty(16, 2, 4, device="meta"), SLOPE)


def _attention_inputs(heads, d, device):
    g = _graph(7, device, torch.float32)        # nodes 40-49: no in-edges
    gen = torch.Generator(device=device).manual_seed(heads * 1000 + d)
    n, ne = g.num_nodes, g.num_edges

    def rn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    keep = torch.rand(ne, heads, device=device, generator=gen) < 0.4
    return g, dict(pi=rn(n, heads), pj=rn(n, heads), v=rn(n, heads, d),
                   dy=rn(n, heads, d), lg=rn(ne, heads),
                   ve=rn(ne, heads, d), sl=rn(n, heads),
                   sv=rn(n, heads, d), mask=keep.float() / 0.4)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 1), (1, 8), (4, 32), (2, 64),
                                     (1, 200)])
def test_attention_kernels_match_plain_on_card(heads, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, x = _attention_inputs(heads, d, "cuda")
    tol = dict(rtol=1e-5, atol=1e-4)
    before = dict(ES.launches)
    for args in ((g.indptr_r, g.col_r, x["lg"], None, x["v"]),
                 (g.indptr_r, g.col_r, x["lg"], x["mask"], x["v"]),
                 (g.indptr_r, None, x["lg"], x["mask"], x["ve"])):
        for a, b in zip(ES.edge_softmax(*args), ES.edge_softmax_plain(*args)):
            torch.testing.assert_close(a, b, **tol)
    args = (g.indptr_r, g.col_r, x["pi"], x["pj"], x["v"], SLOPE)
    got, want = ES.gat_softmax(*args), ES.gat_softmax_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
    assert torch.isneginf(want[1][40:]).all()
    out, mx, den = ES.finalize_softmax(*want, x["sl"], x["sv"])
    bwd = (x["pi"], x["pj"], x["v"], mx, den, (out * x["dy"]).sum(-1),
           x["dy"], SLOPE)
    torch.testing.assert_close(ES.gat_bwd_dpi(g.indptr_r, g.col_r, *bwd),
                               ES.gat_bwd_dpi_plain(g.indptr_r, g.col_r,
                                                    *bwd), **tol)
    for a, b in zip(ES.gat_bwd_rev(g.indptr_s, g.col_s, *bwd),
                    ES.gat_bwd_rev_plain(g.indptr_s, g.col_s, *bwd)):
        torch.testing.assert_close(a, b, **tol)
    torch.cuda.synchronize()
    assert {k: ES.launches[k] - before[k] for k in before
            if ES.launches[k] != before[k]} == {"k3": 1, "k4": 1, "k5": 1,
                                                "k12": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32)])
def test_attention_functions_on_card_match_cpu(heads, d):
    """gat_attention (K3-K5) and attention_aggregate of node values with
    dropout (K12, K2 backward) on the card vs the same autograd functions
    on the CPU (plain versions), forward and every gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    results = {}
    for device in ("cuda", "cpu"):
        g, x = _attention_inputs(heads, d, "cuda")
        g = g.to(device)
        x = {k: v.to(device).requires_grad_(k not in ("mask", "dy"))
             for k, v in x.items()}
        kw = dict(self_logits=x["sl"], self_values=x["sv"])
        out = (ES.gat_attention_nodes(g, x["pi"], x["pj"], x["v"], SLOPE,
                                      **kw)
               + ES.edge_softmax_aggregate_nodes(
                   g, x["lg"], x["v"], dropout_masks=(x["mask"], None),
                   **kw))
        (out * x["dy"]).sum().backward()
        results[device] = [out.detach()] + [
            x[k].grad for k in ("pi", "pj", "v", "lg", "sl", "sv")]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_attention_dispatch_takes_kernels_only_on_card():
    """The kernel route is chosen by the device alone."""
    assert not TA._kernel_route(torch.zeros(1))
    assert not TA._kernel_route(torch.empty(1, device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape_h", [(), (2, 3)])
def test_attention_aggregate_head_dims_on_card(shape_h):
    """``[E, *H]`` logits with no or two head dimensions go to K12 on the
    card (flattened into one) and match the CPU plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(8, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, ne = g.num_nodes, g.num_edges
    x = [torch.randn(*s, device="cuda", generator=gen)
         for s in ((ne,) + shape_h, (n,) + shape_h + (5,),
                   (n,) + shape_h + (5,))]
    results = {}
    for device in ("cuda", "cpu"):
        lg, v, cot = (t.to(device, copy=True).requires_grad_(i < 2)
                      for i, t in enumerate(x))
        before = dict(ES.launches)
        out = TA.attention_aggregate(g.to(device), lg, v, node_values=True)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        assert ES.launches["k12"] - before["k12"] == (device == "cuda")
        results[device] = (out.detach(), lg.grad, v.grad)
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---- GATv2: K9, K10, K11 ---------------------------------------------------

def _lrelu_np(x):
    return np.where(x >= 0, x, SLOPE * x)


def test_gatv2_plain_versions_match_loops():
    """K9-K11's plain versions against the formulas written out edge by
    edge (edge_softmax.py:1283-1296, 1444-1459, 1506-1516), float64."""
    g = _graph(9, "cpu")
    n, heads, o = g.num_nodes, 2, 3
    rng = np.random.default_rng(9)
    q, k, dy = (rng.standard_normal((n, heads, o)) for _ in range(3))
    a = rng.standard_normal((o, heads))
    ss, rs = g.senders.numpy(), g.receivers.numpy()
    lg = np.einsum("ehf,fh->eh", _lrelu_np(q[rs] + k[ss]), a)
    m = np.full((n, heads), -np.inf)
    np.maximum.at(m, rs, lg)
    p = np.exp(lg - m[rs])
    s = np.zeros((n, heads))
    np.add.at(s, rs, p)
    num = np.zeros((n, heads, o))
    np.add.at(num, rs, p[..., None] * k[ss])
    tq, tk, ta, tdy = (torch.tensor(v) for v in (q, k, a, dy))
    got = ES.gatv2_softmax_plain(g.indptr_r, g.col_r, tq, tk, ta, SLOPE)
    for x, want in zip(got, (num, m, s)):
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-12, atol=1e-12)

    out, mx, den = ES.finalize_softmax(*got)
    s_n = (out * tdy).sum(-1)
    mx_, den_, sn_ = (v.numpy() for v in (mx, den, s_n))
    dq, da, dk = np.zeros_like(q), np.zeros_like(a), np.zeros_like(k)
    for e, (r, sd) in enumerate(zip(rs, ss)):
        raw = q[r] + k[sd]
        act = _lrelu_np(raw)
        alpha = np.exp((act * a.T).sum(-1) - mx_[r]) / den_[r]
        dlg = alpha * ((k[sd] * dy[r]).sum(-1) - sn_[r])
        draw = dlg[:, None] * a.T * np.where(raw >= 0, 1.0, SLOPE)
        dq[r] += draw
        da += (act * dlg[:, None]).T
        dk[sd] += draw + alpha[:, None] * dy[r]
    bwd = (tq, tk, ta, mx, den, s_n, tdy, SLOPE)
    got_dq, got_da = ES.gatv2_bwd_dq_plain(g.indptr_r, g.col_r, *bwd)
    got_dk = ES.gatv2_bwd_rev_plain(g.indptr_s, g.col_s, *bwd)
    for x, want in ((got_dq, dq), (got_da, da), (got_dk, dk)):
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-10, atol=1e-12)


def test_gatv2_wrappers_validate_inputs():
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    q, k, a = torch.randn(16, 2, 4), torch.randn(16, 2, 4), torch.randn(4, 2)
    with pytest.raises(TypeError):
        ES._gatv2_args(g.indptr_r, g.col_r, q.double(), k, a, {}, {})
    with pytest.raises(ValueError):        # a is not [O, H]
        ES._gatv2_args(g.indptr_r, g.col_r, q, k, torch.randn(3, 2), {}, {})
    with pytest.raises(ValueError):        # a's heads disagree
        ES._gatv2_args(g.indptr_r, g.col_r, q, k, torch.randn(4, 3), {}, {})
    ES._gatv2_args(g.indptr_r, g.col_r, q, k, a, {"mx": torch.randn(16, 2)},
                   {"dy": torch.randn(16, 2, 4)})
    # widths: 256 vectors of float4 (1024 floats) or of float (256 floats)
    wide = torch.empty(1, 1, 1028)
    ES._check_gatv2_width(1024, wide)
    ES._check_gatv2_width(255, wide)
    for d, t in ((1028, wide), (257, wide),
                 (1024, torch.empty(1025)[1:])):   # 4 bytes off: no float4
        with pytest.raises(ValueError, match="at most 1024 floats"):
            ES._check_gatv2_width(d, t)
    with pytest.raises(ValueError):        # no route for a meta tensor
        ES.gatv2_softmax(g.indptr_r, g.col_r, q, torch.empty(
            16, 2, 4, device="meta"), a, SLOPE)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 6, 8, 12, 16])
def test_gatv2_dq_grid_keeps_one_head_per_warp(heads, monkeypatch):
    """K10's grid is ``_dq_blocks`` blocks of 8 warps of ``2^log_rows``
    receiver rows by H: every warp walks rows of the one head of its block,
    the blocks cover every row once, and ``da``'s scratch holds one partial
    per block and entry, ``[H, O, blocks]``, which the second launch reads
    with the same block count."""
    for n in (1, 7, 8, 1000, 131_072):
        for log_rows in range(6):
            blocks = ES._dq_blocks(n, log_rows)
            rows = 8 << log_rows
            assert (blocks - 1) * rows < n <= blocks * rows
    libs = {False: [], True: []}

    class _Lib:
        def __init__(self, calls):
            self.calls = calls

        def __getattr__(self, name):
            return lambda *args: self.calls.append((name, args)) or 0

    monkeypatch.setattr(ES, "_lib", lambda sweep=False: _Lib(libs[sweep]))
    monkeypatch.setattr(ES, "_call_on", lambda device, fn, *a: fn(*a, None))
    allocs = []
    empty = torch.empty
    monkeypatch.setattr(ES.torch, "empty", lambda *a, **kw: allocs.append(
        a[0]) or empty(*a, **kw))
    g = _graph(10, "cpu", torch.float32)
    n, o = g.num_nodes, 8
    q, k, dy = (torch.randn(n, heads, o) for _ in range(3))
    mx, den, s_n = (torch.randn(n, heads) for _ in range(3))
    ES._gatv2_bwd_dq_kernel(g.indptr_r, g.col_r, q, k, torch.randn(o, heads),
                            mx, den, s_n, dy, SLOPE)
    (walk, walk_args), (reduce_, reduce_args) = libs[False]
    log_rows = walk_args[14]
    blocks = ES._dq_blocks(n, log_rows)
    assert (walk, reduce_) == ("gatv2_bwd_dq_f32", "gatv2_da_reduce_f32")
    assert walk_args[11:14] == (n, heads, o)
    assert (heads, o, blocks) in allocs
    assert reduce_args[2:5] == (blocks, heads, o)


def test_gatv2_cpu_tensors_launch_nothing():
    g = _graph(10, "cpu", torch.float32)
    n = g.num_nodes
    q, k, dy = (torch.randn(n, 2, 4) for _ in range(3))
    a = torch.randn(4, 2)
    before = dict(ES.launches)
    num, m, s = ES.gatv2_softmax(g.indptr_r, g.col_r, q, k, a, SLOPE)
    out, mx, den = ES.finalize_softmax(num, m, s)
    bwd = (q, k, a, mx, den, (out * dy).sum(-1), dy, SLOPE)
    ES.gatv2_bwd_dq(g.indptr_r, g.col_r, *bwd)
    ES.gatv2_bwd_rev(g.indptr_s, g.col_s, *bwd)
    assert ES.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 1), (1, 8), (4, 32), (2, 64),
                                     (1, 67), (1, 200)])
def test_gatv2_kernels_match_plain_on_card(heads, d):
    """K9, K10 (dq and da) and K11 against their plain versions; nodes
    40-49 have no in-edges and no out-edges. (1, 67) takes scalar loads in
    three chunks of 32, (1, 200) float4 loads in two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(11, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads * 1000 + d)
    n = g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, k, dy = rn(n, heads, d), rn(n, heads, d), rn(n, heads, d)
    a = rn(d, heads)
    tol = dict(rtol=1e-5, atol=1e-4)
    before = dict(ES.launches)
    args = (g.indptr_r, g.col_r, q, k, a, SLOPE)
    got, want = ES.gatv2_softmax(*args), ES.gatv2_softmax_plain(*args)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **tol)
    assert torch.isneginf(got[1][40:]).all() and (got[2][40:] == 0).all()
    out, mx, den = ES.finalize_softmax(*want, rn(n, heads), rn(n, heads, d))
    bwd = (q, k, a, mx, den, (out * dy).sum(-1), dy, SLOPE)
    for x, y in zip(ES.gatv2_bwd_dq(g.indptr_r, g.col_r, *bwd),
                    ES.gatv2_bwd_dq_plain(g.indptr_r, g.col_r, *bwd)):
        torch.testing.assert_close(x, y, **tol)
    torch.testing.assert_close(ES.gatv2_bwd_rev(g.indptr_s, g.col_s, *bwd),
                               ES.gatv2_bwd_rev_plain(g.indptr_s, g.col_s,
                                                      *bwd), **tol)
    torch.cuda.synchronize()
    assert {k_: ES.launches[k_] - before[k_] for k_ in before
            if ES.launches[k_] != before[k_]} == {"k9": 1, "k10": 2, "k11": 1}
    with pytest.raises(ValueError, match="at most 1024 floats"):
        ES.gatv2_softmax(g.indptr_r, g.col_r, rn(n, 1, 1028), rn(n, 1, 1028),
                         rn(1028, 1), SLOPE)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 8), (4, 32)])
def test_gatv2_attention_on_card_matches_cpu(heads, d):
    """gatv2_attention on the card (K9 forward, K10 and K11 backward) vs the
    same autograd function on the CPU (plain versions): the forward and the
    gradients of q, k, a and the self-loop terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(12, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads + d)
    n = g.num_nodes
    shapes = ((n, heads, d), (n, heads, d), (d, heads), (n, heads),
              (n, heads, d), (n, heads, d))
    ins = [torch.randn(*s, device="cuda", generator=gen) for s in shapes]
    results = {}
    for device in ("cuda", "cpu"):
        ts = [t.to(device, copy=True).requires_grad_(i < 5)
              for i, t in enumerate(ins)]
        before = dict(ES.launches)
        out = TA.gatv2_attention(g.to(device), *ts[:3], SLOPE,
                                 self_logits=ts[3], self_values=ts[4])
        (out * ts[5]).sum().backward()
        torch.cuda.synchronize()
        launched = {k: ES.launches[k] - before[k] for k in before
                    if ES.launches[k] != before[k]}
        assert launched == ({"k9": 1, "k10": 2, "k11": 1}
                            if device == "cuda" else {})
        results[device] = [out.detach()] + [t.grad for t in ts[:5]]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---- dot attention: K6, K7, K8; the per-edge dot: K13 ----------------------

DOT_SCALE = 0.37


def test_dot_plain_versions_match_loops():
    """K6-K8's and K13's plain versions against the formulas written out
    edge by edge (edge_softmax.py:295-339, 546-650; sddmm.py:36-51), float64,
    O != D, with and without a slope."""
    g = _graph(13, "cpu")
    n, heads, o, d = g.num_nodes, 2, 3, 4
    rng = np.random.default_rng(13)
    q, k = rng.standard_normal((n, heads, o)), rng.standard_normal(
        (n, heads, o))
    v, dy = rng.standard_normal((n, heads, d)), rng.standard_normal(
        (n, heads, d))
    ss, rs = g.senders.numpy(), g.receivers.numpy()
    tq, tk, tv, tdy = (torch.tensor(a) for a in (q, k, v, dy))
    np.testing.assert_allclose(
        SD.sddmm_plain(g.indptr_r, g.col_r, tq, tk).numpy(),
        np.einsum("ehf,ehf->eh", q[rs], k[ss]), rtol=1e-12, atol=1e-12)
    for slope in (None, SLOPE):
        raw = DOT_SCALE * np.einsum("ehf,ehf->eh", q[rs], k[ss])
        lg = raw if slope is None else _lrelu_np(raw)
        m = np.full((n, heads), -np.inf)
        np.maximum.at(m, rs, lg)
        p = np.exp(lg - m[rs])
        s = np.zeros((n, heads))
        np.add.at(s, rs, p)
        num = np.zeros((n, heads, d))
        np.add.at(num, rs, p[..., None] * v[ss])
        got = ES.dot_softmax_plain(g.indptr_r, g.col_r, tq, tk, tv,
                                   DOT_SCALE, slope)
        for x, want in zip(got, (num, m, s)):
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-12,
                                       atol=1e-12)
        out, mx, den = ES.finalize_softmax(*got)
        s_n = (out * tdy).sum(-1)
        mx_, den_, sn_ = (a.numpy() for a in (mx, den, s_n))
        dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
        for e, (r, sd) in enumerate(zip(rs, ss)):
            alpha = np.exp(lg[e] - mx_[r]) / den_[r]
            dsig = DOT_SCALE * (1.0 if slope is None
                                else np.where(raw[e] >= 0, 1.0, SLOPE))
            dlg = alpha * ((v[sd] * dy[r]).sum(-1) - sn_[r]) * dsig
            dq[r] += dlg[:, None] * k[sd]
            dk[sd] += dlg[:, None] * q[r]
            dv[sd] += alpha[:, None] * dy[r]
        bwd = (tq, tk, tv, mx, den, s_n, tdy, DOT_SCALE, slope)
        got_dq = ES.dot_bwd_dq_plain(g.indptr_r, g.col_r, *bwd)
        got_dk, got_dv = ES.dot_bwd_rev_plain(g.indptr_s, g.col_s, *bwd)
        for x, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-10,
                                       atol=1e-12)


def test_dot_and_sddmm_wrappers_validate_inputs():
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    q, k, v = torch.randn(16, 2, 4), torch.randn(16, 2, 4), torch.randn(
        16, 2, 6)
    ES._dot_args(g.indptr_r, g.col_r, q, k, v, {"mx": torch.randn(16, 2)},
                 {}, {"dy": torch.randn(16, 2, 6)})
    with pytest.raises(TypeError):
        ES._dot_args(g.indptr_r, g.col_r, q.double(), k, v, {}, {}, {})
    with pytest.raises(ValueError):        # values' heads disagree
        ES._dot_args(g.indptr_r, g.col_r, q, k, torch.randn(16, 3, 6), {},
                     {}, {})
    with pytest.raises(ValueError):        # dy is not D wide
        ES._dot_args(g.indptr_r, g.col_r, q, k, v, {}, {},
                     {"dy": torch.randn(16, 2, 4)})
    with pytest.raises(ValueError):        # k and v: the senders, one count
        ES._dot_args(g.indptr_r, g.col_r, q, k, v[:15], {}, {}, {})
    # the wider of O and D sets the register chunks: 1024 floats with
    # float4 vectors, 256 without
    ES._dot_args(g.indptr_r, g.col_r, torch.randn(16, 1, 8),
                 torch.randn(16, 1, 8), torch.randn(16, 1, 1024), {}, {}, {})
    for o, d in ((8, 1028), (1028, 8), (5, 257)):
        with pytest.raises(ValueError, match="at most 1024 floats"):
            ES._dot_args(g.indptr_r, g.col_r, torch.randn(16, 1, o),
                         torch.randn(16, 1, o), torch.randn(16, 1, d), {}, {},
                         {})
    with pytest.raises(ValueError):        # no route for a meta tensor
        ES.dot_softmax(g.indptr_r, g.col_r, q, k,
                       torch.empty(16, 2, 6, device="meta"), 1.0, None)
    with pytest.raises(ValueError):
        SD.sddmm_csr(g.indptr_r, g.col_r, q,
                     torch.empty(16, 2, 4, device="meta"))
    with pytest.raises(ValueError, match="disagree"):
        SD.sddmm(g, q, v)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(1, 1, 1), (1, 8, 8), (4, 32, 32),
                                       (2, 64, 16), (1, 67, 5),
                                       (1, 128, 128)])
def test_dot_kernels_match_plain_on_card(heads, o, d):
    """K6, K7 and K8 (plain dot, and with a slope) and K13 against their
    plain versions; nodes 40-49 have no in-edges and no out-edges. (1, 67,
    5) takes scalar loads in three chunks of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(14, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads * 1000 + o + d)
    n = g.num_nodes

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    q, k = rn(n, heads, o), rn(n, heads, o)
    v, dy = rn(n, heads, d), rn(n, heads, d)
    scale = o ** -0.5
    tol = dict(rtol=1e-5, atol=1e-4)
    before = (dict(ES.launches), dict(SD.launches))
    for slope in (None, SLOPE):
        args = (g.indptr_r, g.col_r, q, k, v, scale, slope)
        got, want = ES.dot_softmax(*args), ES.dot_softmax_plain(*args)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, **tol)
        assert torch.isneginf(got[1][40:]).all() and (got[2][40:] == 0).all()
        out, mx, den = ES.finalize_softmax(*want, rn(n, heads),
                                           rn(n, heads, d))
        bwd = (q, k, v, mx, den, (out * dy).sum(-1), dy, scale, slope)
        torch.testing.assert_close(
            ES.dot_bwd_dq(g.indptr_r, g.col_r, *bwd),
            ES.dot_bwd_dq_plain(g.indptr_r, g.col_r, *bwd), **tol)
        for x, y in zip(ES.dot_bwd_rev(g.indptr_s, g.col_s, *bwd),
                        ES.dot_bwd_rev_plain(g.indptr_s, g.col_s, *bwd)):
            torch.testing.assert_close(x, y, **tol)
    torch.testing.assert_close(SD.sddmm_csr(g.indptr_r, g.col_r, q, k),
                               SD.sddmm_plain(g.indptr_r, g.col_r, q, k),
                               **tol)
    torch.cuda.synchronize()
    launched = {kk: c - before[0].get(kk, 0) for kk, c in ES.launches.items()
                if c != before[0].get(kk, 0)}
    assert launched == {"k6": 2, "k7": 2, "k8": 2}
    assert SD.launches["k13"] == before[1]["k13"] + 1
    with pytest.raises(ValueError, match="at most 1024 floats"):
        ES.dot_softmax(g.indptr_r, g.col_r, rn(n, 1, 8), rn(n, 1, 8),
                       rn(n, 1, 1028), 1.0, None)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 7, 32, 128, 512, 1028])
def test_sddmm_kernel_matches_plain_on_card(d):
    """K13 at every width (no gate): rows wider than 32 vectors loop over
    chunks and add to out[e]; (1028) takes more chunks than the dot
    kernels' register limit allows them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(15, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(d)
    xi = torch.randn(g.num_nodes, 1, d, device="cuda", generator=gen)
    xj = torch.randn(g.num_nodes, 1, d, device="cuda", generator=gen)
    torch.testing.assert_close(SD.sddmm_csr(g.indptr_r, g.col_r, xi, xj),
                               SD.sddmm_plain(g.indptr_r, g.col_r, xi, xj),
                               rtol=1e-5, atol=1e-4)


def _ragged_graph(seed):
    """50 nodes, 290 edges: receivers 40-48 have none, row 49 takes 40 (two
    batches of 32 column indices), the others ~6; every node sends."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([np.arange(50), rng.integers(0, 50, 200),
                        rng.integers(0, 6, 40)])
    r = np.concatenate([rng.integers(0, 40, 250), np.full(40, 49)])
    return tgnn.graph(s, r, num_nodes=50, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(h, d) for h in (1, 4)
                                     for d in (1, 7, 32, 128, 260, 512)])
def test_sddmm_pairs_per_warp_on_card(heads, d):
    """K13, four (row, head) pairs per warp with the next pair's operands
    loaded ahead, against the plain version: rows without edges, a row of
    40 edges, 50 and 200 pairs (a short last warp at one head). 260 and 512
    take several chunks of 128 floats, 7 and 1 scalar loads. Two calls give
    the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _ragged_graph(heads * 1000 + d)
    gen = torch.Generator(device="cuda").manual_seed(d)
    xi = torch.randn(50, heads, d, device="cuda", generator=gen)
    xj = torch.randn(50, heads, d, device="cuda", generator=gen)
    args = (g.indptr_r, g.col_r, xi, xj)
    before = SD.launches["k13"]
    got = SD.sddmm_csr(*args)
    torch.testing.assert_close(got, SD.sddmm_plain(*args), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(SD.sddmm_csr(*args), got)
    torch.cuda.synchronize()
    assert SD.launches["k13"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(1, 8, 8), (4, 32, 32), (2, 6, 4)])
def test_dot_attention_on_card_matches_cpu(heads, o, d):
    """dot_attention on the card (K6 forward, K7 and K8 backward) and
    dot_attention_logits (K13 forward, K1 backward) vs the same functions
    on the CPU, the forward and every gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(16, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads + o + d)
    n = g.num_nodes
    shapes = ((n, heads, o), (n, heads, o), (n, heads, d), (n, heads),
              (n, heads, d), (n, heads, d))
    ins = [torch.randn(*s, device="cuda", generator=gen) for s in shapes]
    results = {}
    for device in ("cuda", "cpu"):
        ts = [t.to(device, copy=True).requires_grad_(i < 5)
              for i, t in enumerate(ins)]
        gd = g.to(device)
        before = (dict(ES.launches), dict(SD.launches), dict(S.launches))
        out = TA.dot_attention(gd, *ts[:3], o ** -0.5, self_logits=ts[3],
                               self_values=ts[4])
        lg = TA.dot_attention_logits(gd, ts[0], ts[1])
        ((out * ts[5]).sum() + (lg * lg).sum()).backward()
        torch.cuda.synchronize()
        after = (ES.launches, SD.launches, S.launches)
        launched = {k: c - b[k] for b, a in zip(before, after)
                    for k, c in a.items() if c != b[k]}
        assert launched == ({"k6": 1, "k7": 1, "k8": 1, "k13": 1,
                             "k1": 2 * heads} if device == "cuda" else {})
        results[device] = [out.detach(), lg.detach()] + [t.grad
                                                         for t in ts[:5]]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---- segment max (K14) -------------------------------------------------------

def _segment_inputs(f, device, seed=0):
    """A CSR of 40 rows over 150 entries with rows 5, 6 and 30 empty, data
    ``[150, f]`` on a coarse grid (exact ties) with one NaN entry, and a
    cotangent ``[40, f]``, float32."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice([i for i in range(40) if i not in (5, 6, 30)],
                             150))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=40))])
    data = np.round(rng.standard_normal((150, f)) * 2) / 2
    data[17, f // 2] = np.nan
    dy = rng.standard_normal((40, f))
    def tt(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)
    return ids, tt(indptr, torch.int32), tt(data), tt(dy)


def test_segment_plain_versions_match_loops():
    ids, indptr, data, dy = _segment_inputs(3, "cpu")
    d = data.numpy()
    mx, mn = SG.segment_max_plain(indptr, data), SG.segment_min_plain(
        indptr, data)
    want_mx, want_mn = np.full((40, 3), -np.inf), np.full((40, 3), np.inf)
    for r in range(40):
        rows = d[ids == r]
        if len(rows):
            want_mx[r] = np.max(rows, 0)     # NaN wins, as in the kernel
            want_mn[r] = np.min(rows, 0)
    np.testing.assert_array_equal(mx.numpy(), want_mx)
    np.testing.assert_array_equal(mn.numpy(), want_mn)
    dd = SG.segment_max_bwd_plain(indptr, data, mx, dy).numpy()
    for e, r in enumerate(ids):
        hits = d[ids == r] == want_mx[r]
        want = np.where(d[e] == want_mx[r], dy.numpy()[r]
                        / np.maximum(hits.sum(0), 1), 0)
        np.testing.assert_array_equal(dd[e], want.astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 3, 4, 8, 64, 128, 200, 260])
def test_segment_max_kernels_match_plain_on_card(f):
    """K14 (max, min) and its backward against the plain versions: equal
    bits (a max picks one of its inputs; the backward divides the same dy
    by the same count), rows without entries, exact ties, a NaN entry.
    Widths past 128 floats take several chunks per row; 3 and 1 the scalar
    path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _, indptr, data, dy = _segment_inputs(f, "cuda", seed=f)
    before = dict(SG.launches)
    for kernel, plain in ((SG.segment_max_csr, SG.segment_max_plain),
                          (SG.segment_min_csr, SG.segment_min_plain)):
        torch.testing.assert_close(kernel(indptr, data),
                                   plain(indptr, data), rtol=0, atol=0,
                                   equal_nan=True)
    out = SG.segment_max_plain(indptr, data)
    torch.testing.assert_close(SG.segment_max_bwd_csr(indptr, data, out, dy),
                               SG.segment_max_bwd_plain(indptr, data, out,
                                                        dy), rtol=0, atol=0)
    torch.cuda.synchronize()
    assert SG.launches["k14"] == before["k14"] + 2
    assert SG.launches["k14_bwd"] == before["k14_bwd"] + 1


@pytest.mark.parametrize("fv,n_rows,entries,per_group,want", [
    (1, 131072, 2_000_000, 4, 4),   # F=4 logits: 16 rows of 2 groups
    (1, 131072, 2_000_000, 2, 3),   # its backward: 8 rows of 4 groups
    (2, 131072, 2_000_000, 4, 3),   # F=8: 8 rows of 2 groups of 2 lanes
    (2, 131072, 2_000_000, 2, 2),   # its backward: 4 rows of 4 groups
    (16, 4096, 77_556, 4, 0),       # graph CSR F=64: one row, 2 groups
    (16, 4096, 4096 * 5, 4, 1),     # short rows: 2 rows, 1 group each
    (32, 131072, 2_000_000, 2, 0),  # 32 vectors: one warp per row
    (200, 10, 100, 4, 0),           # chunks of 32 vectors
    (1, 40, 150, 4, 5),             # 3.75 entries: one lane per row
    (1, 10, 10_000, 4, 0),          # 1,000 entries: 32 groups
    (3, 7, 0, 2, 3),                # no entries at all
])
def test_rows_per_warp_rule(fv, n_rows, entries, per_group, want):
    """K14's rows per warp: the most edge groups (powers of two, of G
    lanes) that each still walk ``per_group`` entries on average, and as
    many rows as fit in 32 lanes; wide rows one per warp. The wrappers'
    targets: _FWD_ENTRIES_PER_GROUP and _BWD_ENTRIES_PER_GROUP."""
    assert (SG._FWD_ENTRIES_PER_GROUP, SG._BWD_ENTRIES_PER_GROUP) == (4, 2)
    log_rows = SG._rows_per_warp(fv, n_rows, entries, per_group)
    assert log_rows == want
    log_g = min((fv - 1).bit_length(), 5)
    assert 0 <= log_rows <= 5 - log_g
    groups = 32 >> (log_g + log_rows)
    mean = entries / n_rows
    if groups > 1:
        assert mean / groups >= per_group
    if log_rows > 0:   # one more group would walk too few entries
        assert mean / (2 * groups) < per_group


def _rows_per_warp_csr(f, seed):
    """A CSR of 45 rows (a multiple of no rows-per-warp above 1) whose rows
    0, 3, 4, 7, 8, 15, 16, 31, 32 and 44 (on the boundaries of 2 to 32 rows
    per warp) are empty and row 20 has 40 entries, over data on a grid of
    1/2 (exact ties) with one NaN; and a cotangent. float32 on the card."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 7, 45)
    counts[[0, 3, 4, 7, 8, 15, 16, 31, 32, 44]] = 0
    counts[20] = 40
    indptr = np.concatenate([[0], np.cumsum(counts)])
    data = np.round(rng.standard_normal((indptr[-1], f)) * 2) / 2
    data[indptr[20] + 5, f // 2] = np.nan
    dy = rng.standard_normal((45, f))
    return (torch.tensor(indptr, dtype=torch.int32, device="cuda"),
            torch.tensor(data, dtype=torch.float32, device="cuda"),
            torch.tensor(dy, dtype=torch.float32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 3, 4, 5, 8, 16])
def test_segment_max_rows_per_warp_on_card(f):
    """K14 max and min and its backward at every rows-per-warp the width
    allows (and the wrapper's own choice), bit for bit against the plain
    versions: empty rows on warp boundaries, a row of 40 entries, ties and
    a NaN. A layout wider than the warp is refused and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    indptr, data, dy = _rows_per_warp_csr(f, seed=f)
    want = {op_min: (SG.segment_min_plain if op_min
                     else SG.segment_max_plain)(indptr, data)
            for op_min in (False, True)}
    out = want[False]
    want_bwd = SG.segment_max_bwd_plain(indptr, data, out, dy)
    log_g = ((f // 4 if f % 4 == 0 else f) - 1).bit_length()
    for log_rows in (None, *range(6 - log_g)):
        for op_min in (False, True):
            torch.testing.assert_close(
                SG._segment_extreme_kernel(op_min, indptr, data, log_rows),
                want[op_min], rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(
            SG._segment_max_bwd_kernel(indptr, data, out, dy, log_rows),
            want_bwd, rtol=0, atol=0)
    before = dict(SG.launches)
    with pytest.raises(RuntimeError, match="invalid argument"):
        SG._segment_extreme_kernel(False, indptr, data, 6 - log_g)
    with pytest.raises(RuntimeError, match="invalid argument"):
        SG._segment_max_bwd_kernel(indptr, data, out, dy, 6 - log_g)
    torch.cuda.synchronize()
    assert SG.launches == before


@pytest.mark.gpu
def test_graph_ops_on_card_match_cpu():
    """The graph-wise ops, max aggregation and pooling on the card (K14)
    against the same functions on the CPU, forward and input gradients,
    with the launches of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    graphs, _ = tgnn.data.synthetic_tudataset(6, seed=1, device="cpu")
    gb = tgnn.batch(graphs, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(gb.num_nodes, 5, device="cuda", generator=gen)
    e = torch.randn(gb.num_edges, 4, device="cuda", generator=gen)
    ops = tgnn.ops
    cases = [
        (lambda g, x, e: ops.reduce_nodes("max", g, x), {"k14": 1,
                                                         "k14_bwd": 1}),
        (lambda g, x, e: ops.reduce_edges("min", g, e), {"k14": 1,
                                                         "k14_bwd": 1}),
        (lambda g, x, e: ops.softmax_nodes(g, x), {"k14": 1}),
        (lambda g, x, e: ops.softmax_edges(g, e), {"k14": 1}),
        (lambda g, x, e: ops.softmax_edge_neighbors(g, e), {"k14": 1}),
        (lambda g, x, e: ops.aggregate_neighbors(g, "max", e),
         {"k14": 1, "k14_bwd": 1}),
        (lambda g, x, e: tgnn.models.GlobalPool("min")(g, x),
         {"k14": 1, "k14_bwd": 1}),
    ]
    for i, (fn, launches) in enumerate(cases):
        results = {}
        for device in ("cuda", "cpu"):
            xs, es = (v.to(device, copy=True).requires_grad_()
                      for v in (x, e))
            before = dict(SG.launches)
            out = fn(gb.to(device), xs, es)
            (out * out).sum().backward()
            torch.cuda.synchronize()
            launched = {k: c - before[k] for k, c in SG.launches.items()
                        if c != before[k]}
            assert launched == (launches if device == "cuda" else {}), i
            results[device] = [out.detach(), xs.grad, es.grad]
        for a, b in zip(results["cuda"], results["cpu"]):
            if b is not None:
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["graphconv", "sage", "gin", "edgeconv",
                                  "edgeconv_min"])
def test_max_aggregation_layers_on_card_match_cpu(name):
    """Each layer with a max or min aggregation reaches K14 on the card
    (one forward, one backward launch) and matches itself on the CPU,
    forward and the gradients of the input and of every parameter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    M = tgnn.models
    gen = torch.Generator().manual_seed(4)
    kw = dict(generator=gen, device="cpu")
    layer = {
        "graphconv": lambda: M.GraphConv(5, 4, aggr="max", **kw),
        "sage": lambda: M.SAGEConv(5, 4, aggr="max", **kw),
        "gin": lambda: M.GINConv(M.MLP([5, 4], **kw), 0.1, aggr="max"),
        "edgeconv": lambda: M.EdgeConv(M.MLP([10, 6, 4], **kw)),
        "edgeconv_min": lambda: M.EdgeConv(M.MLP([10, 4], **kw),
                                           aggr="min"),
    }[name]()
    graphs, _ = tgnn.data.synthetic_tudataset(6, seed=2, device="cpu")
    g = tgnn.batch(graphs, device="cpu")
    x = torch.randn(g.num_nodes, 5, generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        m = layer.to(device)
        m.zero_grad(set_to_none=True)
        xs = x.to(device).requires_grad_()
        before = dict(SG.launches)
        out = m(g.to(device), xs)
        (out * out).sum().backward()
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in SG.launches.items()
                    if c != before[k]}
        assert launched == ({"k14": 1, "k14_bwd": 1} if device == "cuda"
                            else {})
        results[device] = [out.detach().cpu(), xs.grad.cpu()] + [
            p.grad.cpu() for p in m.parameters()]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_k1_one_column_and_reversed_edge_ids_on_card():
    """K1 at D = 1 (the matrix-free ChebConv's power iteration, one column a
    graph) and K1's forward over a reversed graph's receiver CSR, reading
    the weights through its edge-id map, against the plain version; then
    ``propagate`` and ``apply_edges`` on the reversed graph on the card
    against the CPU, with their launches (K1 forward, K2 backward with the
    weights' gradient by CSR position, K1 as the receiver gather's
    backward through ``eid_r``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n, e = 3000, 45000
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = tgnn.rand_graph(n, e, seed=8, device="cuda")
    w = torch.rand(g.num_edges, device="cuda", generator=gen) + 0.5
    gr = g.replace(edge_weight=w).reverse()
    for d in (1, 8, 128):
        x = torch.randn(n, d, device="cuda", generator=gen)
        for args in ((g.indptr_r, g.col_r, None, None, x),
                     (g.indptr_r, g.col_r, None, w, x),
                     (g.indptr_s, g.col_s, g.eid_s, w, x),
                     (gr.indptr_r, gr.col_r, gr.eid_r, w, x),
                     (gr.indptr_r, gr.col_r, gr.eid_r, None, x)):
            torch.testing.assert_close(S.spmm_csr(*args),
                                       S.spmm_plain(*args),
                                       rtol=1e-5, atol=1e-5)
    x = torch.randn(n, 4, device="cuda", generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        gd = gr.to(device)
        xs = x.to(device, copy=True).requires_grad_()
        ws = w.to(device, copy=True).requires_grad_()
        before = dict(S.launches)
        y = tgnn.ops.propagate(tgnn.ops.w_mul_xj, gd, "sum", xj=xs, e=ws)
        m = tgnn.ops.apply_edges(lambda a, b, _: a * b, gd, xs, xs)
        (y * y).sum().backward()
        (m * m).sum().backward()
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in S.launches.items()
                    if c != before[k]}
        assert launched == ({"k1": 3, "k2": 1} if device == "cuda" else {})
        results[device] = [y.detach().cpu(), m.detach().cpu(),
                           xs.grad.cpu(), ws.grad.cpu()]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resgated", "sgconv", "tagconv", "dconv",
                                  "dconv_reference_exact", "gatedgraph",
                                  "cheb_lambda_given", "cheb_power"])
def test_propagation_layers_on_card_match_cpu(name):
    """The propagation family on the card in float32 (K1 every hop; DConv
    over the weighted graph and its reverse; ChebConv's matrix-free path
    at N = 2100 >= 2048, by default with its power iteration at D = 1)
    against itself on the CPU in float64, forward and the gradients of the
    input and of every parameter.

    Tolerance: an element passes through ~50 float32 roundings (a 5-wide
    GEMM, up to three hops of ~15 terms, the ``2 T - T0`` recursions, the
    GRU's gates), each up to 6e-8 of the largest term it adds, so its error
    is within ~3e-6 of the tensor's largest value: atol 1e-5 * max|b|
    (CPU float32 against float64 reads 2e-7 to 4e-7 of it for every case;
    DConv's raw-degree mode reaches 7e4 in its outputs, 7e9 in its input
    gradient, and cancels in ``2 T - T0``, so an elementwise rtol alone
    fails it: 2.9e-4 on one of 8,400 elements, card float32 against CPU
    float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    M = tgnn.models
    gen = torch.Generator().manual_seed(9)
    kw = dict(generator=gen, device="cpu")
    layer = {
        "resgated": lambda: M.ResGatedGraphConv(5, 4, torch.relu, **kw),
        "sgconv": lambda: M.SGConv(5, 4, 2, **kw),
        "tagconv": lambda: M.TAGConv(5, 4, 3, **kw),
        "dconv": lambda: M.DConv(5, 4, 3, **kw),
        "dconv_reference_exact": lambda: M.DConv(5, 4, 2,
                                                 reference_exact=True, **kw),
        "gatedgraph": lambda: M.GatedGraphConv(6, 2, **kw),
        "cheb_lambda_given": lambda: M.ChebConv(5, 4, 3, **kw),
        "cheb_power": lambda: M.ChebConv(5, 4, 3, **kw),
    }[name]()
    call = {"cheb_lambda_given": {"lambda_max": 2.0}}.get(name, {})
    g = tgnn.rand_graph(2100, 30000, seed=10, device="cpu")
    g = g.replace(edge_weight=torch.rand(g.num_edges, generator=gen) + 0.5)
    x = torch.randn(g.num_nodes, 5, generator=gen)
    results = {}
    for device, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = copy.deepcopy(layer).to(device, dt)
        xs = x.to(device, dt).requires_grad_()
        before = dict(S.launches)
        out = m(g.to(device), xs, **call)
        (out * out).sum().backward()
        torch.cuda.synchronize()
        assert (S.launches["k1"] > before["k1"]) is (device == "cuda")
        results[device] = [out.detach().cpu(), xs.grad.cpu()] + [
            p.grad.cpu() for p in m.parameters()]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a.double(), b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_start_vector_on_card_equals_cpu():
    """The power iterations' start vector (``query.start_vector``) is the
    same bits on the card as on the CPU, in float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphneuralnetworks_tpu_torch.query import start_vector
    for dt in (torch.float32, torch.float64):
        torch.testing.assert_close(start_vector((300, 2), dt, "cuda").cpu(),
                                   start_vector((300, 2), dt, "cpu"),
                                   rtol=0, atol=0)


# ---- bfloat16: K1-K14 -----------------------------------------------------

def _assert_bf16_close(got, want):
    """Kernel and plain version each round one float32 sum to bfloat16;
    their sums differ in order only (float32: the float32 cases' 1e-4), so
    a rounding may land one bfloat16 ulp apart."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double().cpu(), want.double().cpu()
    _, e = torch.frexp(w.abs().clamp(min=torch.finfo(torch.float32).tiny))
    ulp = torch.exp2(e.double() - 8)          # |w| in [2^(e-1), 2^e)
    err = (g - w).abs()
    assert bool((err <= ulp + 1e-4).all()), float((err / (ulp + 1e-4)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 7, 8, 12, 128])
def test_spmm_bf16_kernel_matches_plain_on_card(d):
    """K1 on bfloat16 rows and weights: 16-byte vectors (d = 8, 128), 8-byte
    ones (12) and single values (1, 7), over the receiver CSR (nodes 40-49
    have no in-edges) and the sender CSR, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(6, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(g.num_nodes, d, device="cuda", generator=gen).bfloat16()
    w = g.edge_weight.bfloat16()
    before = dict(S.launches)
    for args in ((g.indptr_r, g.col_r, None, None, x),
                 (g.indptr_r, g.col_r, None, w, x),
                 (g.indptr_s, g.col_s, g.eid_s, w, x)):
        got = S.spmm_csr(*args)
        _assert_bf16_close(got, S.spmm_plain(*args))
        assert (got[40:] == 0).all()          # no in-edges (no out-edges)
    torch.cuda.synchronize()
    assert S.launches["k1_bf16"] == before["k1_bf16"] + 3
    assert S.launches["k1"] == before["k1"]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 7), (2, 12), (1, 8), (4, 32),
                                     (1, 128), (1, 264)])
def test_gat_bf16_kernels_match_plain_on_card(heads, d):
    """K3, K4 and K5 on bfloat16 rows and scalars with the float32 state:
    16-byte vectors (8, 32, 128; 264: 33 vectors, two passes), 8-byte ones
    (12) and single values (7); nodes 40-49 have no in-edges. Outputs in
    their primals' types; m, s at the float32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, x = _attention_inputs(heads, d, "cuda")
    x = {k: v.bfloat16() for k, v in x.items()}
    before = dict(ES.launches)
    args = (g.indptr_r, g.col_r, x["pi"], x["pj"], x["v"], SLOPE)
    (num, m, s), (pnum, pm, ps) = (ES.gat_softmax(*args),
                                   ES.gat_softmax_plain(*args))
    _assert_bf16_close(num, pnum)
    for a, b in ((m, pm), (s, ps)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    assert torch.isneginf(pm[40:]).all() and (num[40:] == 0).all()
    out, mx, den = ES.finalize_softmax(pnum, pm, ps, x["sl"], x["sv"])
    s_n = (out.float() * x["dy"].float()).sum(-1)
    bwd = (x["pi"], x["pj"], x["v"], mx, den, s_n, x["dy"], SLOPE)
    _assert_bf16_close(ES.gat_bwd_dpi(g.indptr_r, g.col_r, *bwd),
                       ES.gat_bwd_dpi_plain(g.indptr_r, g.col_r, *bwd))
    for a, b in zip(ES.gat_bwd_rev(g.indptr_s, g.col_s, *bwd),
                    ES.gat_bwd_rev_plain(g.indptr_s, g.col_s, *bwd)):
        _assert_bf16_close(a, b)
    torch.cuda.synchronize()
    assert {k: ES.launches[k] - before[k] for k in before
            if ES.launches[k] != before[k]} == {"k3_bf16": 1, "k4_bf16": 1,
                                                "k5_bf16": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o", [(1, 8), (2, 4), (4, 32), (1, 13),
                                     (1, 264)])
def test_gatv2_bf16_kernels_match_plain_on_card(heads, o):
    """K9, K10 (dq and da) and K11 on bfloat16 q, k, dy and a with the
    float32 state: 16-byte vectors (8, 32; 264: 33 vectors, two register
    chunks), 8-byte ones (4) and single values (13); nodes 40-49 have no
    in-edges and no out-edges. num, dq and dk within one bfloat16 ulp of
    the plain versions; m, s and da (float32) at the float32 tolerance;
    only the bfloat16 variants launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(13, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads * 1000 + o)
    n = g.num_nodes

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).bfloat16()

    q, k, dy = rn(n, heads, o), rn(n, heads, o), rn(n, heads, o)
    a = rn(o, heads, scale=(2.0 / (o + heads)) ** 0.5)
    tol = dict(rtol=1e-5, atol=1e-4)
    before = dict(ES.launches)
    args = (g.indptr_r, g.col_r, q, k, a, SLOPE)
    (num, m, s), (pnum, pm, ps) = (ES.gatv2_softmax(*args),
                                   ES.gatv2_softmax_plain(*args))
    _assert_bf16_close(num, pnum)
    for x, y in ((m, pm), (s, ps)):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, **tol)
    assert torch.isneginf(pm[40:]).all() and (num[40:] == 0).all()
    out, mx, den = ES.finalize_softmax(pnum, pm, ps, rn(n, heads),
                                       rn(n, heads, o))
    bwd = (q, k, a, mx, den, (out.float() * dy.float()).sum(-1), dy, SLOPE)
    (dq, da), (pdq, pda) = (ES.gatv2_bwd_dq(g.indptr_r, g.col_r, *bwd),
                            ES.gatv2_bwd_dq_plain(g.indptr_r, g.col_r, *bwd))
    _assert_bf16_close(dq, pdq)
    assert da.dtype == pda.dtype == torch.float32
    torch.testing.assert_close(da, pda, **tol)
    _assert_bf16_close(ES.gatv2_bwd_rev(g.indptr_s, g.col_s, *bwd),
                       ES.gatv2_bwd_rev_plain(g.indptr_s, g.col_s, *bwd))
    torch.cuda.synchronize()
    assert {k_: ES.launches[k_] - before[k_] for k_ in before
            if ES.launches[k_] != before[k_]} == {"k9_bf16": 1,
                                                  "k10_bf16": 2,
                                                  "k11_bf16": 1}


def _gatv2_scales(g, n_dst, q, k, a, sl, sv, dy, slope):
    """S of gatv2_attention's output and of the gradients of ``q, k, a,
    sl, sv``: each the same sum over the absolute values of its terms, in
    float64 (tests/test_torch_gatv2_bf16.py derives the bounds)."""
    q, k, a, sl, sv, dy = (t.detach().double().cpu()
                           for t in (q, k, a, sl, sv, dy))
    s, r = g.senders.long().cpu(), g.receivers.long().cpu()
    raw = q[r] + k[s]
    act = torch.where(raw >= 0, raw, slope * raw)
    dsig = torch.where(raw >= 0, 1.0, slope)
    lg = torch.einsum("eho,oh->eh", act, a)
    mx = torch.full(q.shape[:2], float("-inf"), dtype=torch.float64)
    mx = mx.scatter_reduce(0, r[:, None].expand_as(lg), lg, "amax")
    mx = torch.maximum(mx, sl)
    ex = torch.exp(lg - mx[r])
    ex_self = torch.exp(sl - mx)
    den = torch.zeros_like(mx).index_add_(0, r, ex) + ex_self
    alpha, a_self = ex / den[r], ex_self / den
    s_out = (a_self[..., None] * sv.abs()).index_add_(
        0, r, alpha[..., None] * k[s].abs())
    sn_abs = (s_out * dy.abs()).sum(-1)
    terms = alpha * ((k[s] * dy[r]).abs().sum(-1) + sn_abs[r])
    draw = terms[..., None] * a.t().abs() * dsig
    s_dq = torch.zeros(q.shape, dtype=torch.float64).index_add_(0, r, draw)
    s_dk = torch.zeros(k.shape, dtype=torch.float64).index_add_(
        0, s, draw + alpha[..., None] * dy[r].abs())
    s_da = torch.einsum("eh,eho->oh", terms, act.abs())
    s_dsl = a_self * ((sv * dy).abs().sum(-1) + sn_abs)
    s_dsv = a_self[..., None] * dy.abs()
    assert q.shape[0] == n_dst
    return s_out, [s_dq, s_dk, s_da, s_dsl, s_dsv]


@pytest.mark.gpu
@pytest.mark.parametrize("n_src,n_dst", [(50, 50), (30, 50), (50, 30)])
def test_gatv2_bf16_attention_on_card_matches_cpu(monkeypatch, n_src,
                                                  n_dst):
    """gatv2_attention on bfloat16 CUDA tensors (K9, K10, K11 in bfloat16,
    no cast: only the _bf16 launches) against the same autograd function
    on the CPU (the kernels' plain versions), at (H, O) = (4, 32), also
    with N_src != N_dst through the cut CSRs (``_rows``, ``_senders``):
    the output within 5 u S, the gradients of q, k, a and the self logits
    within 9 u S, the self values' within 2 u S, S the same sums over
    absolute values (the bounds of tests/test_torch_gatv2_bf16.py, which
    also count the JAX kernels' extra roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    heads, o, u = 4, 32, 2.0 ** -8
    rng = np.random.default_rng(n_src * 7 + n_dst)
    s = rng.integers(0, n_src, 400)
    r = rng.integers(0, min(n_dst, 40), 400)   # the last rows: no in-edges
    g = tgnn.graph(s, r, num_nodes=max(n_src, n_dst), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(n_src + n_dst)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).bfloat16()
    ins = [rn(n_dst, heads, o), rn(n_src, heads, o),
           rn(o, heads, scale=(2.0 / (o + heads)) ** 0.5), rn(n_dst, heads),
           rn(n_dst, heads, o)]
    cot = torch.randn(n_dst, heads, o, device="cuda", generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
        ts = [t.to(device, copy=True).requires_grad_() for t in ins]
        before = dict(ES.launches)
        out = TA.gatv2_attention(g.to(device), *ts[:3], SLOPE,
                                 self_logits=ts[3], self_values=ts[4],
                                 num_segments=n_dst)
        (out.float() * cot.to(device)).sum().backward()
        torch.cuda.synchronize()
        launched = {k: ES.launches[k] - before[k] for k in before
                    if ES.launches[k] != before[k]}
        assert launched == ({"k9_bf16": 1, "k10_bf16": 2, "k11_bf16": 1}
                            if device == "cuda" else {})
        assert out.dtype == torch.bfloat16
        assert all(t.grad.dtype == torch.bfloat16 for t in ts)
        results[device] = [out] + [t.grad for t in ts]
    s_out, s_grads = _gatv2_scales(g, n_dst, *ins,
                                   cot.bfloat16().double(), SLOPE)
    for i, (x, y, scale, k) in enumerate(zip(
            results["cuda"], results["cpu"], [s_out] + s_grads,
            [5, 9, 9, 9, 9, 2])):
        err = (x.detach().double().cpu() - y.detach().double()).abs()
        tol = k * u * scale + 1e-5 * scale + 1e-6
        assert bool((err <= tol).all()), (i, float((err / tol).max()))


@pytest.mark.gpu
def test_precision_gatv2_step_on_card_matches_cpu(monkeypatch):
    """One forward and backward of ``Precision(GNNChain(GATv2Conv(heads=4),
    GATv2Conv))`` on the card (only K9, K10 and K11 in bfloat16: 2, 4 and
    2 launches) against the same model on the CPU through the same
    autograd functions (plain versions): the output within 18 u of max
    |out|, the float32 gradients within 18 u by norm (two layers of 9 u:
    tests/test_torch_gatv2_bf16.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    u = 2.0 ** -8
    g = _graph(14, "cuda", torch.float32)
    gen = torch.Generator().manual_seed(14)
    model = tgnn.models.Precision(tgnn.models.GNNChain(
        tgnn.models.GATv2Conv(16, 8, torch.relu, heads=4, generator=gen,
                              device="cuda"),
        tgnn.models.GATv2Conv(32, 4, generator=gen, device="cuda")))
    x = torch.randn(g.num_nodes, 16, generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
        m = copy.deepcopy(model).to(device)
        before = dict(ES.launches)
        out = m(g.to(device), x.to(device))
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        launched = {k: ES.launches[k] - before[k] for k in before
                    if ES.launches[k] != before[k]}
        assert launched == ({"k9_bf16": 2, "k10_bf16": 4, "k11_bf16": 2}
                            if device == "cuda" else {})
        assert out.dtype == torch.bfloat16
        results[device] = (out.detach().double().cpu(),
                           [p.grad.double().cpu() for p in m.parameters()])
    (oc, gc), (oh, gh) = results["cuda"], results["cpu"]
    assert float((oc - oh).abs().max()) <= 18 * u * float(oh.abs().max())
    for a, b in zip(gc, gh):
        assert float((a - b).norm() / b.norm()) <= 18 * u


def _dot_bf16_kernels_case(g, heads, o, d, seed):
    """K6 (with the raw logits written), K7 (from them and recomputing
    them) and K8 on bfloat16 rows over ``g``, plain dot and with a slope,
    against their plain versions: num, dq, dk and dv within one bfloat16
    ulp, m, s and the raw logits (float32) at the float32 tolerance; only
    the bfloat16 variants launched."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, ne = g.num_nodes, g.num_edges
    ir, cr, is_, cs = g.indptr_r, g.col_r, g.indptr_s, g.col_s

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    q, k, v, dy = rn(n, heads, o), rn(n, heads, o), rn(n, heads, d), \
        rn(n, heads, d)
    scale, tol = o ** -0.5, dict(rtol=1e-5, atol=1e-4)
    before = dict(ES.launches)
    for slope in (None, SLOPE):
        args = (ir, cr, q, k, v, scale, slope)
        raw, praw = (torch.empty(ne, heads, device="cuda") for _ in range(2))
        num, m, s = ES.dot_softmax(*args, raw)
        pnum, pm, ps = ES.dot_softmax_plain(*args, praw)
        _assert_bf16_close(num, pnum)
        for x, y in ((m, pm), (s, ps), (raw, praw)):
            assert x.dtype == torch.float32
            torch.testing.assert_close(x, y, **tol)
        out, mx, den = ES.finalize_softmax(pnum, pm, ps, rn(n, heads),
                                           rn(n, heads, d))
        bwd = (q, k, v, mx, den, (out.float() * dy.float()).sum(-1), dy,
               scale, slope)
        for given in (None, praw):
            _assert_bf16_close(ES.dot_bwd_dq(ir, cr, *bwd, given),
                               ES.dot_bwd_dq_plain(ir, cr, *bwd, given))
        for x, y in zip(ES.dot_bwd_rev(is_, cs, *bwd),
                        ES.dot_bwd_rev_plain(is_, cs, *bwd)):
            _assert_bf16_close(x, y)
    torch.cuda.synchronize()
    assert {k_: ES.launches[k_] - before[k_] for k_ in before
            if ES.launches[k_] != before[k_]} == {"k6_bf16": 2,
                                                  "k7_bf16": 4,
                                                  "k8_bf16": 2}
    return q, k, v


# the graph sizes of chip_smoke.py's 2h (bench.py's train graph), whose
# chosen bfloat16 K6 and K8 layouts the card tests run on their own graphs
MAIN_N, MAIN_E = 131_072, 2_000_000


def _dot_bf16_layouts_case(g, heads, o, d, seed, k6_layouts=()):
    """bfloat16 K6 (writing the raw logits) and K8 at each layout their
    choosers give at this graph's size and at 2h's (``MAIN_N``,
    ``MAIN_E``), and K6 also at ``k6_layouts``, each from the sweep build,
    plain dot and with a slope: num, dk and dv within one bfloat16 ulp of
    the plain version, m, s and the raw logits at the float32 tolerance,
    and a second run the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, ne = g.num_nodes, g.num_edges

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    q, k, v, dy = rn(n, heads, o), rn(n, heads, o), rn(n, heads, d), \
        rn(n, heads, d)
    ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
    lays6 = {ES._dot_recv_layout(ov, dv, vec, n, rows, ent, 2)
             for rows, ent in ((n, ne), (MAIN_N, MAIN_E))} | set(k6_layouts)
    lays8 = {ES._dot_bwd_rev_layout(ov, dv, rows, ent, vec, 2)
             for rows, ent in ((n, ne), (MAIN_N, MAIN_E))}
    tol = dict(rtol=1e-5, atol=1e-4)
    for slope in (None, SLOPE):
        fwd = (g.indptr_r, g.col_r, q, k, v, o ** -0.5, slope)
        praw = torch.empty(ne, heads, device="cuda")
        want = ES.dot_softmax_plain(*fwd, praw)
        for lay in sorted(lays6):
            runs = []
            for _ in range(2):
                raw = torch.empty(ne, heads, device="cuda")
                runs.append(ES._dot_softmax_kernel(*fwd, raw, lay) + (raw,))
            _assert_bf16_close(runs[0][0], want[0])
            for x, y in zip(runs[0][1:], want[1:] + (praw,)):
                torch.testing.assert_close(x, y, **tol)
            assert all(torch.equal(a, b) for a, b in zip(*runs)), lay
        out, mx, den = ES.finalize_softmax(*want, rn(n, heads),
                                           rn(n, heads, d))
        bwd = (g.indptr_s, g.col_s, q, k, v, mx, den,
               (out.float() * dy.float()).sum(-1), dy, o ** -0.5, slope)
        want8 = ES.dot_bwd_rev_plain(*bwd)
        for lay in sorted(lays8):
            runs = [ES._dot_bwd_rev_kernel(*bwd, layout=lay)
                    for _ in range(2)]
            for x, y in zip(runs[0], want8):
                _assert_bf16_close(x, y)
            assert all(torch.equal(a, b) for a, b in zip(*runs)), lay
    torch.cuda.synchronize()
    return lays6, lays8


@pytest.mark.gpu
@pytest.mark.parametrize("heads,o,d", [(4, 32, 32), (1, 8, 8), (1, 13, 13),
                                       (2, 4, 12), (1, 264, 264),
                                       (1, 128, 128), (1, 1032, 1032)])
def test_dot_bf16_kernels_match_plain_on_card(heads, o, d):
    """K6, K7 and K8 on bfloat16 rows in rows: 16-byte vectors (32, 8;
    264: 33 vectors, two register chunks; 128; 1032: 129 vectors, eight
    chunks, K8 reading k and v again at each dot), 8-byte ones (4 and 12) and
    single values (13); nodes 40-49 have no in-edges and no out-edges. K6
    and K8 also at each layout their choosers give here and at 2h's size,
    forward and backward, the same bits in two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(16, "cuda", torch.float32)
    _dot_bf16_kernels_case(g, heads, o, d, heads * 1000 + o + d)
    _dot_bf16_layouts_case(g, heads, o, d, heads * 1000 + o + d + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("o,vec_bytes", [(128, 16), (132, 8), (129, 2)])
def test_dot_bf16_strips_match_plain_on_card(o, vec_bytes):
    """K6 and K7 on bfloat16 rows on a graph whose sender table is wider
    than ``_DOT_STRIP_BYTES``: in strips for 4- and 1-value vectors (strips
    of a 128-byte line, 16 or 32 vectors), in rows for AGNN's (1, 128,
    128) bf16x8 head (both asserted: K6's and K7's one rule), and K8 beside
    them, against their plain versions; K6 also at the strips and at its
    chooser's layouts here and at 2h's size, and K8 at its, the same bits
    in two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = tgnn.rand_graph(80_000, 400_000, seed=o, device="cuda")
    q, k, v = _dot_bf16_kernels_case(g, 1, o, o, o)
    ov, dv, vec = ES._dot_vectors(o, o, q, k, v)
    assert vec == vec_bytes
    for kernel in (6, 7):
        assert ES._dot_recv_layout(ov, dv, vec, g.num_nodes, g.num_nodes,
                                   g.num_edges, 2, kernel)[0] == (vec != 16)
    _dot_bf16_layouts_case(g, 1, o, o, o + 1, [ES._dot_softmax_bf16_layout(
        ov, dv, vec, g.num_nodes, g.num_nodes, g.num_edges, strips=True)])


def _dot_scales(g, n_dst, q, k, v, sl, sv, dy, scale):
    """S of dot_attention's output and of the gradients of ``q, k, v, sl,
    sv``: each the same sum over the absolute values of its terms, in
    float64 (tests/test_torch_dot_bf16.py derives the bounds)."""
    q, k, v, sl, sv, dy = (t.detach().double().cpu()
                           for t in (q, k, v, sl, sv, dy))
    s, r = g.senders.long().cpu(), g.receivers.long().cpu()
    lg = scale * (q[r] * k[s]).sum(-1)
    mx = torch.full(q.shape[:2], float("-inf"), dtype=torch.float64)
    mx = mx.scatter_reduce(0, r[:, None].expand_as(lg), lg, "amax")
    mx = torch.maximum(mx, sl)
    ex = torch.exp(lg - mx[r])
    ex_self = torch.exp(sl - mx)
    den = torch.zeros_like(mx).index_add_(0, r, ex) + ex_self
    alpha, a_self = ex / den[r], ex_self / den
    s_out = (a_self[..., None] * sv.abs()).index_add_(
        0, r, alpha[..., None] * v[s].abs())
    sn_abs = (s_out * dy.abs()).sum(-1)
    terms = alpha * ((v[s] * dy[r]).abs().sum(-1) + sn_abs[r]) * scale
    s_dq = torch.zeros(q.shape, dtype=torch.float64).index_add_(
        0, r, terms[..., None] * k[s].abs())
    s_dk = torch.zeros(k.shape, dtype=torch.float64).index_add_(
        0, s, terms[..., None] * q[r].abs())
    s_dv = torch.zeros(v.shape, dtype=torch.float64).index_add_(
        0, s, alpha[..., None] * dy[r].abs())
    s_dsl = a_self * ((sv * dy).abs().sum(-1) + sn_abs)
    s_dsv = a_self[..., None] * dy.abs()
    assert q.shape[0] == n_dst
    return s_out, [s_dq, s_dk, s_dv, s_dsl, s_dsv]


@pytest.mark.gpu
@pytest.mark.parametrize("n_src,n_dst", [(50, 50), (30, 50), (50, 30)])
def test_dot_bf16_attention_on_card_matches_cpu(monkeypatch, n_src, n_dst):
    """dot_attention on bfloat16 CUDA tensors (K6, K7, K8 in bfloat16, no
    cast: only the _bf16 launches) against the same autograd function on
    the CPU (the kernels' plain versions), at (H, O, D) = (4, 32, 32) and
    TransformerConv's scale, also with N_src != N_dst through the cut CSRs
    (``_rows``, ``_senders``): the output within 5 u S, the gradients of
    q, k and the self logits within 9 u S, of v and the self values within
    2 u S, S the same sums over absolute values (the bounds of
    tests/test_torch_dot_bf16.py, which also count the JAX kernels' extra
    roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    heads, o, u, scale = 4, 32, 2.0 ** -8, 32 ** -0.5
    rng = np.random.default_rng(n_src * 11 + n_dst)
    s = rng.integers(0, n_src, 400)
    r = rng.integers(0, min(n_dst, 40), 400)   # the last rows: no in-edges
    g = tgnn.graph(s, r, num_nodes=max(n_src, n_dst), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(n_src + n_dst + 1)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    ins = [rn(n_dst, heads, o), rn(n_src, heads, o), rn(n_src, heads, o),
           rn(n_dst, heads), rn(n_dst, heads, o)]
    cot = torch.randn(n_dst, heads, o, device="cuda", generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
        ts = [t.to(device, copy=True).requires_grad_() for t in ins]
        before = dict(ES.launches)
        out = TA.dot_attention(g.to(device), *ts[:3], scale,
                               self_logits=ts[3], self_values=ts[4],
                               num_segments=n_dst)
        (out.float() * cot.to(device)).sum().backward()
        torch.cuda.synchronize()
        launched = {k: ES.launches[k] - before[k] for k in before
                    if ES.launches[k] != before[k]}
        assert launched == ({"k6_bf16": 1, "k7_bf16": 1, "k8_bf16": 1}
                            if device == "cuda" else {})
        assert out.dtype == torch.bfloat16
        assert all(t.grad.dtype == torch.bfloat16 for t in ts)
        results[device] = [out] + [t.grad for t in ts]
    s_out, s_grads = _dot_scales(g, n_dst, *ins, cot.bfloat16().double(),
                                 scale)
    for i, (x, y, sc, k) in enumerate(zip(
            results["cuda"], results["cpu"], [s_out] + s_grads,
            [5, 9, 9, 2, 9, 2])):
        err = (x.detach().double().cpu() - y.detach().double()).abs()
        tol = k * u * sc + 1e-5 * sc + 1e-6
        assert bool((err <= tol).all()), (i, float((err / tol).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["transformer", "agnn"])
def test_precision_dot_step_on_card_matches_cpu(monkeypatch, kind):
    """One forward and backward of ``Precision(GNNChain(
    TransformerConv(heads=4), TransformerConv))`` and of
    ``Precision(GNNChain(AGNNConv(), AGNNConv()))`` on the card (only K6,
    K7 and K8 in bfloat16: 2 launches each; AGNN's first layer takes no
    K8, its k and v being the input's, which needs no gradient) against
    the same model on the CPU through the same autograd functions (plain
    versions): the output
    within 26 u of max |out|, the float32 gradients within 26 u by norm
    (two layers of 13 u: tests/test_torch_dot_bf16.py; the key bias's,
    whose exact value is 0, of the largest gradient's norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    u = 2.0 ** -8
    g = _graph(17, "cuda", torch.float32)
    gen = torch.Generator().manual_seed(17)
    M = tgnn.models
    if kind == "transformer":
        inner = M.GNNChain(
            M.TransformerConv(16, 8, heads=4, generator=gen, device="cuda"),
            M.TransformerConv(32, 4, generator=gen, device="cuda"))
    else:
        inner = M.GNNChain(M.AGNNConv(device="cuda"),
                           M.AGNNConv(device="cuda"))
    model = M.Precision(inner)
    x = torch.randn(g.num_nodes, 16, generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
        m = copy.deepcopy(model).to(device)
        before = dict(ES.launches)
        out = m(g.to(device), x.to(device))
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        launched = {k: ES.launches[k] - before[k] for k in before
                    if ES.launches[k] != before[k]}
        want = {"k6_bf16": 2, "k7_bf16": 2,
                "k8_bf16": 2 if kind == "transformer" else 1}
        assert launched == (want if device == "cuda" else {})
        assert out.dtype == torch.bfloat16
        results[device] = (out.detach().double().cpu(),
                           {n: p.grad.double().cpu()
                            for n, p in m.named_parameters()})
    (oc, gc), (oh, gh) = results["cuda"], results["cpu"]
    assert float((oc - oh).abs().max()) <= 26 * u * float(oh.abs().max())
    largest = max(float(b.norm()) for b in gh.values())
    for name, b in gh.items():
        sc = largest if name.endswith("W4.bias") else float(b.norm())
        assert float((gc[name] - b).norm()) <= 26 * u * sc, name


@pytest.mark.gpu
def test_bf16_kernels_refuse_a_mix_on_card():
    """float32 weights with bfloat16 rows (K1), a float32 pi with bfloat16
    values (K3), a bfloat16 state (K4), a float32 q with bfloat16 k (K9),
    float32 values with bfloat16 q and k (K6) or a bfloat16 s_n (K11,
    K8): TypeError, nothing launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, x = _attention_inputs(2, 8, "cuda")
    b = {k: v.bfloat16() for k, v in x.items()}
    before = {**S.launches, **ES.launches}
    with pytest.raises(TypeError):
        S.spmm_csr(g.indptr_r, g.col_r, None, g.edge_weight,
                   b["v"][:, 0].contiguous())
    with pytest.raises(TypeError):
        ES.gat_softmax(g.indptr_r, g.col_r, x["pi"], b["pj"], b["v"], SLOPE)
    with pytest.raises(TypeError):
        ES.gat_bwd_dpi(g.indptr_r, g.col_r, b["pi"], b["pj"], b["v"],
                       b["pi"], b["pi"], b["pi"], b["dy"], SLOPE)
    a = b["v"][0].t().contiguous()            # [O, H]
    with pytest.raises(TypeError):
        ES.gatv2_softmax(g.indptr_r, g.col_r, x["v"], b["v"], a, SLOPE)
    with pytest.raises(TypeError):
        ES.dot_softmax(g.indptr_r, g.col_r, b["v"], b["v"], x["v"], 1.0,
                       None)
    with pytest.raises(TypeError):              # a bfloat16 s_n
        ES.dot_bwd_rev(g.indptr_s, g.col_s, b["v"], b["v"], b["v"],
                       x["pi"], x["pi"], b["pi"], b["dy"], 1.0, None)
    with pytest.raises(TypeError):
        ES.gatv2_bwd_rev(g.indptr_s, g.col_s, b["v"], b["v"], a, x["pi"],
                         x["pi"], b["pi"], b["dy"], SLOPE)
    assert {**S.launches, **ES.launches} == before


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 7), (1, 12), (1, 8), (1, 128),
                                     (4, 32), (2, 264)])
def test_spmm_sddmm_bf16_kernel_matches_plain_on_card(heads, d):
    """K2 on bfloat16 rows and weights, over the sender CSR: single values
    (7), 8-byte vectors (12), 16-byte ones (8, 128: two strips of 64
    values), several heads by sender-CSR position (4, 32; 2, 264: two
    strips a head), against the plain version; dx and dw in bfloat16, and
    only K2's bfloat16 variant launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(16, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(heads * 1000 + d)
    n, ne = g.num_nodes, g.num_edges
    shape = (n, d) if heads == 1 else (n, heads, d)

    def rn(*sh):
        return torch.randn(*sh, device="cuda", generator=gen).bfloat16()
    dy, x = rn(*shape), rn(*shape)
    w = rn(*((ne,) if heads == 1 else (ne, heads)))
    before = dict(S.launches)
    for weights in (w, None):
        args = (g.indptr_s, g.col_s, g.eid_s, weights, dy, x)
        for a, b in zip(S.spmm_sddmm(*args), S.spmm_sddmm_plain(*args)):
            _assert_bf16_close(a, b)
    torch.cuda.synchronize()
    assert {k: S.launches[k] - before[k] for k in before
            if S.launches[k] != before[k]} == {"k2_bf16": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 7), (2, 12), (1, 8), (4, 32),
                                     (1, 264)])
def test_edge_softmax_bf16_kernel_matches_plain_on_card(heads, d):
    """K12 on bfloat16 logits, mask and values with the float32 state:
    node values with and without the dropout mask, edge values with it;
    16-byte vectors (8, 32; 264: 33 vectors, two passes), 8-byte ones (12)
    and single values (7); nodes 40-49 have no in-edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, x = _attention_inputs(heads, d, "cuda")
    x = {k: v.bfloat16() for k, v in x.items()}
    before = dict(ES.launches)
    for args in ((g.indptr_r, g.col_r, x["lg"], None, x["v"]),
                 (g.indptr_r, g.col_r, x["lg"], x["mask"], x["v"]),
                 (g.indptr_r, None, x["lg"], x["mask"], x["ve"])):
        (num, m, s), (pnum, pm, ps) = (ES.edge_softmax(*args),
                                       ES.edge_softmax_plain(*args))
        _assert_bf16_close(num, pnum)
        for a, b in ((m, pm), (s, ps)):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
        assert torch.isneginf(m[40:]).all() and (num[40:] == 0).all()
    torch.cuda.synchronize()
    assert {k: ES.launches[k] - before[k] for k in before
            if ES.launches[k] != before[k]} == {"k12_bf16": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(1, 1), (1, 7), (1, 12), (1, 128),
                                     (4, 32), (1, 300), (2, 520)])
def test_sddmm_bf16_kernel_matches_plain_on_card(heads, d):
    """K13 on bfloat16 rows against the plain version: single values (1,
    7), 8-byte vectors (12; 300: 75 vectors, three chunks through the
    float32 scratch), 16-byte ones (128, 32; 520: 65 vectors, three
    chunks), one dot rounded once; then its backward (K1 in bfloat16
    twice) through ``sddmm`` against K1's plain version weighted by the
    bfloat16 ``dl``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _ragged_graph(17)
    gen = torch.Generator(device="cuda").manual_seed(heads * 1000 + d)
    n = g.num_nodes
    xi, xj = (torch.randn(n, heads, d, device="cuda", generator=gen)
              .bfloat16() for _ in range(2))
    before = (dict(SD.launches), dict(S.launches))
    _assert_bf16_close(SD.sddmm_csr(g.indptr_r, g.col_r, xi, xj),
                       SD.sddmm_plain(g.indptr_r, g.col_r, xi, xj))
    dl = torch.randn(g.num_edges, heads, device="cuda",
                     generator=gen).bfloat16()
    a, b = xi.clone().requires_grad_(), xj.clone().requires_grad_()
    SD.sddmm(g, a, b).backward(dl)
    for h in range(heads):   # K1's plain version, weighted by dl
        w = dl[:, h].contiguous()
        _assert_bf16_close(a.grad[:, h], S.spmm_plain(
            g.indptr_r, g.col_r, None, w, xj[:, h].contiguous()))
        _assert_bf16_close(b.grad[:, h], S.spmm_plain(
            g.indptr_s, g.col_s, g.eid_s, w, xi[:, h].contiguous()))
    torch.cuda.synchronize()
    assert SD.launches["k13_bf16"] == before[0]["k13_bf16"] + 2
    assert S.launches["k1_bf16"] == before[1]["k1_bf16"] + 2 * heads
    assert SD.launches["k13"] == before[0]["k13"]


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 3, 4, 8, 12, 64, 128, 264])
def test_segment_max_bf16_kernels_match_plain_on_card(f):
    """K14 (max, min) and its backward on bfloat16 against the plain
    versions bit for bit: rows without entries, exact ties, a NaN entry;
    16-byte vectors (8, 64, 128, 264: 33 vectors, two chunks), 8-byte ones
    (4, 12) and single values (1, 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _, indptr, data, dy = _segment_inputs(f, "cuda", seed=f)
    data, dy = data.bfloat16(), dy.bfloat16()
    before = dict(SG.launches)
    for kernel, plain in ((SG.segment_max_csr, SG.segment_max_plain),
                          (SG.segment_min_csr, SG.segment_min_plain)):
        got = kernel(indptr, data)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, plain(indptr, data), rtol=0, atol=0,
                                   equal_nan=True)
    out = SG.segment_max_plain(indptr, data)
    torch.testing.assert_close(SG.segment_max_bwd_csr(indptr, data, out, dy),
                               SG.segment_max_bwd_plain(indptr, data, out,
                                                        dy), rtol=0, atol=0)
    torch.cuda.synchronize()
    assert {k: SG.launches[k] - before[k] for k in before
            if SG.launches[k] != before[k]} == {"k14_bf16": 2,
                                                "k14_bwd_bf16": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 4, 8, 128])
def test_segment_max_bf16_backward_past_256_ties_on_card(f):
    """K14's bfloat16 backward where a row's maximum ties 300 and 260
    times: its count stops at 256, as the plain version's and JAX's do
    (``ops.segment.extreme_grad``), so each tie gets dy / 256, bit for bit;
    beside them a row of 3 ties, an empty row and a row without ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(f)
    indptr = torch.tensor([0, 300, 303, 303, 700, 710], dtype=torch.int32,
                          device="cuda")
    data = torch.randn(710, f, device="cuda", generator=gen)
    data[:300] = 0.5
    data[300:303] = 2.0
    data[303:563] = 9.0
    dy = torch.randn(5, f, device="cuda", generator=gen).bfloat16()
    data = data.bfloat16()
    out = SG.segment_max_csr(indptr, data)
    torch.testing.assert_close(out, SG.segment_max_plain(indptr, data),
                               rtol=0, atol=0)
    before = dict(SG.launches)
    got = SG.segment_max_bwd_csr(indptr, data, out, dy)
    want = SG.segment_max_bwd_plain(indptr, data, out, dy)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got[:300], (dy[:1] / 256).expand(300, f),
                               rtol=0, atol=0)
    torch.testing.assert_close(got[303:563], (dy[3:4] / 256).expand(260, f),
                               rtol=0, atol=0)
    torch.cuda.synchronize()
    assert SG.launches["k14_bwd_bf16"] == before["k14_bwd_bf16"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [7, 8, 128])
def test_gather_backward_bf16_on_card(d):
    """apply_edges' endpoint gathers of a bfloat16 table: each backward is
    one launch of K1's bfloat16 variant over the edge rows (by receiver,
    by sender), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(18, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(g.num_nodes, d, device="cuda", generator=gen).bfloat16()
    cot = torch.randn(g.num_edges, d, device="cuda", generator=gen).bfloat16()
    ops = tgnn.ops
    for msg, indptr, eid in ((ops.copy_xi, g.indptr_r, g.eid_r),
                             (ops.copy_xj, g.indptr_s, g.eid_s)):
        before = dict(S.launches)
        a = x.clone().requires_grad_()
        ops.apply_edges(msg, g, xi=a, xj=a).backward(cot)
        torch.cuda.synchronize()
        assert {k: S.launches[k] - before[k] for k in before
                if S.launches[k] != before[k]} == {"k1_bf16": 1}
        _assert_bf16_close(a.grad, S.spmm_plain(indptr, eid, None, None,
                                                cot))


@pytest.mark.gpu
@pytest.mark.parametrize("n_src,n_dst", [(900, 300), (300, 900)])
def test_k1_on_a_relation_graph_on_card(n_src, n_dst):
    """K1 through a hetero relation's graph, built over max(N_src, N_dst)
    nodes: the forward over the receiver CSR with ``x_src`` of N_src rows,
    and the sender-CSR backward cut to those rows (``SpmmFunction``),
    against the plain versions; then ``propagate`` mean, card against
    CPU, with K1 launched once each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(n_src)
    et = ("a", "to", "b")
    s, r = rng.integers(0, n_src, 6000), rng.integers(0, n_dst, 6000)
    hg = tgnn.heterograph({et: (s, r)}, num_nodes={"a": n_src, "b": n_dst},
                          device="cuda")
    g = hg.relation_graph(et)
    assert g.num_nodes == max(n_src, n_dst)
    gen = torch.Generator(device="cuda").manual_seed(n_dst)
    for d in (1, 8, 128):
        x = torch.randn(n_src, d, device="cuda", generator=gen)
        dy = torch.randn(g.num_nodes, d, device="cuda", generator=gen)
        ip = g.indptr_s[: n_src + 1]
        for args in ((g.indptr_r, g.col_r, None, None, x),
                     (ip, g.col_s, g.eid_s, None, dy)):
            torch.testing.assert_close(S.spmm_csr(*args),
                                       S.spmm_plain(*args),
                                       rtol=1e-5, atol=1e-5)
    x = torch.randn(n_src, 16, device="cuda", generator=gen)
    cot = torch.randn(n_dst, 16, device="cuda", generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        gd = hg.to(device).relation_graph(et)
        xs = x.to(device, copy=True).requires_grad_()
        before = dict(S.launches)
        y = tgnn.ops.propagate(tgnn.ops.copy_xj, gd, "mean", xj=xs)[:n_dst]
        (y * cot.to(device)).sum().backward()
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in S.launches.items()
                    if c != before[k]}
        assert launched == ({"k1": 2} if device == "cuda" else {})
        results[device] = [y.detach().cpu(), xs.grad.cpu()]
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_hetero_conv_step_on_card_matches_cpu():
    """One forward and backward of a HeteroGraphConv (SAGE, GraphConv,
    bipartite GCN and GAT without self-loops) over types of 700 and 250
    nodes, card in float32 against CPU in float64: every output, the
    inputs' gradients and every parameter's, within 1e-5 of the tensor's
    largest value (a few float32 roundings of sums of ~20 terms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    M = tgnn.models
    sizes = {"big": 700, "small": 250}
    rng = np.random.default_rng(12)
    rels = {("big", "r0", "small"): 5000, ("small", "r1", "big"): 4000,
            ("big", "r2", "big"): 6000, ("small", "r3", "small"): 2000}
    hg = tgnn.heterograph(
        {et: (rng.integers(0, sizes[et[0]], ne),
              rng.integers(0, sizes[et[2]], ne)) for et, ne in rels.items()},
        num_nodes=sizes, device="cpu")
    gen = torch.Generator().manual_seed(12)
    kw = dict(generator=gen, device="cpu")
    conv = M.HeteroGraphConv({
        ("big", "r0", "small"): M.SAGEConv(6, 5, **kw),
        ("small", "r1", "big"): M.GraphConv(6, 5, torch.relu, **kw),
        ("big", "r2", "big"): M.GCNConv(6, 5, **kw),
        ("small", "r3", "small"): M.GATConv(6, 5, heads=1,
                                            add_self_loops=False, **kw)},
        aggr="mean")
    x = {nt: torch.randn(n, 6, generator=gen) for nt, n in sizes.items()}
    results = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = copy.deepcopy(conv).to(device, dtype)
        g = hg.to(device)
        xs = {nt: v.to(device, dtype).requires_grad_()
              for nt, v in x.items()}
        out = m(g, xs)
        sum((v * v).sum() for v in out.values()).backward()
        results[device] = ([out[nt].detach() for nt in sorted(out)]
                           + [xs[nt].grad for nt in sorted(xs)]
                           + [p.grad for p in m.parameters()])
    for a, b in zip(results["cuda"], results["cpu"]):
        a = a.cpu().double()
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


# ---- the CSR views: reversed and compacted graphs on the card -------------

def _view_graph(which):
    """A graph on the card and its ``graph.csr_view``: a ``DeviceSampler``
    slot graph (fanout 4 without replacement, so short rows and the seeds
    without in-edges leave invalid edges) compacted to its valid edges, or
    a reversed graph, whose receiver CSR reads edges through ``eid_r``."""
    from graphneuralnetworks_tpu_torch.device_sampler import DeviceSampler
    from graphneuralnetworks_tpu_torch.graph import csr_view

    if which == "reversed":
        g = tgnn.rand_graph(20_000, 300_000, seed=3, device="cuda").reverse()
    else:
        rng = np.random.default_rng(3)
        s = rng.integers(0, 4000, 12_000)
        r = rng.integers(0, 3500, 12_000)   # nodes 3500-3999: no in-edges
        order = np.argsort(r, kind="stable")
        ptr = np.r_[0, np.cumsum(np.bincount(r, minlength=4000))]
        sp = DeviceSampler.build(s[order].astype(np.int32), ptr,
                                 fanouts=(4,), batch_size=2048,
                                 replace=False, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        seeds = torch.randint(0, 4000, (2048,), generator=gen,
                              device="cuda")
        g = sp.sample(gen, seeds)
        assert not g.edge_valid.all()
    return g, csr_view(g)


def _by_position(t, eid):
    return t if eid is None else t.index_select(0, eid.long())


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["compacted", "reversed"])
def test_view_kernels_match_plain_on_card(which):
    """K3 (float32 and bfloat16), K12 (node and edge values, with a mask,
    read through the view's edge-id map) and K14 and its backward (float32
    and bfloat16, bit for bit) over a compacted and a reversed receiver
    CSR against their plain versions over the same view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, v = _view_graph(which)
    n, e, h, d = g.num_nodes, g.num_edges, 2, 16
    entries = int(v.indptr_r[-1])
    assert (entries < e) == (which == "compacted")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    before = {**ES.launches, **SG.launches}
    pi, pj, vals = rn(n, h), rn(n, h), rn(n, h, d)
    for dt in (torch.float32, torch.bfloat16):
        args = (v.indptr_r, v.col_r, pi.to(dt), pj.to(dt), vals.to(dt),
                SLOPE)
        (num, m, s), (pnum, pm, ps) = (ES.gat_softmax(*args),
                                       ES.gat_softmax_plain(*args))
        if dt == torch.float32:
            torch.testing.assert_close(num, pnum, rtol=1e-5, atol=1e-5)
        else:
            _assert_bf16_close(num, pnum)
        torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-4)
    lg, mask, vals_e = rn(e, h), (rn(e, h) > 0).float() * 2, rn(e, h, d)
    for col, values in ((v.col_r, vals), (None, _by_position(vals_e,
                                                             v.eid_r))):
        args = (v.indptr_r, col, _by_position(lg, v.eid_r),
                _by_position(mask, v.eid_r), values)
        for a, b in zip(ES.edge_softmax(*args), ES.edge_softmax_plain(*args)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    data = torch.round(rn(e, 8) * 4) / 4      # ties on a grid of 1/4
    for dt in (torch.float32, torch.bfloat16):
        dp = _by_position(data, v.eid_r).to(dt)
        out = SG.segment_max_csr(v.indptr_r, dp)
        want = SG.segment_max_plain(v.indptr_r, dp)
        assert torch.equal(out, want)
        dy = rn(n, 8).to(dt)
        got = SG.segment_max_bwd_csr(v.indptr_r, dp, want, dy)[:entries]
        assert torch.equal(got, SG.segment_max_bwd_plain(
            v.indptr_r, dp, want, dy)[:entries])
    torch.cuda.synchronize()
    launched = {k: c - before[k] for k, c in {**ES.launches,
                                              **SG.launches}.items()
                if c != before[k]}
    assert launched == {"k3": 1, "k3_bf16": 1, "k12": 2, "k14": 1,
                        "k14_bf16": 1, "k14_bwd": 1, "k14_bwd_bf16": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["compacted", "reversed"])
def test_view_routes_card_vs_cpu(which):
    """``aggregate_neighbors(max)``, ``gat_attention`` with and without
    dropout masks and ``apply_edges(xi_dot_xj)`` on the card over the view
    (K14, K3-K5, K12 with K2, K13 with K1) against the CPU's plain route
    in float64, outputs and input gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, _ = _view_graph(which)
    gc = g.to("cpu")
    n, e, h, d = g.num_nodes, g.num_edges, 2, 16
    gen = torch.Generator().manual_seed(2)
    masks = ((torch.rand(e, h, generator=gen) < 0.5) * 2.0, None)
    routes = {
        "max": (lambda gg, m: tgnn.ops.aggregate_neighbors(gg, "max", m),
                [(e, d)]),
        "gat": (lambda gg, pi, pj, vv: tgnn.ops.gat_attention(
            gg, pi, pj, vv, SLOPE), [(n, h), (n, h), (n, h, d)]),
        "gat_dropout": (lambda gg, pi, pj, vv: tgnn.ops.gat_attention(
            gg, pi, pj, vv, SLOPE, dropout_masks=tuple(
                None if mm is None else mm.to(pi) for mm in masks)),
            [(n, h), (n, h), (n, h, d)]),
        "xi_dot_xj": (lambda gg, a, b: tgnn.ops.apply_edges(
            tgnn.ops.xi_dot_xj, gg, a, b), [(n, d), (n, d)]),
    }
    for name, (fn, shapes) in routes.items():
        ins = [torch.randn(*s_, generator=gen, dtype=torch.float64)
               for s_ in shapes]
        res = []
        for gg, dev, dt in ((g, "cuda", torch.float32),
                            (gc, "cpu", torch.float64)):
            ts = [x.to(dev, dt).requires_grad_() for x in ins]
            out = fn(gg, *ts)
            cot = torch.ones_like(out).cumsum(0) / out.shape[0]
            (out * cot).sum().backward()
            res.append([out.detach().double().cpu()]
                       + [x.grad.double().cpu() for x in ts])
        for a, b in zip(*res):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                       msg=name)
