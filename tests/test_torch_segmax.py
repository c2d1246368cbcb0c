"""The port's segment max (K14's module, ``ops/cuda/segment.py``) vs the JAX
package.

- K14's function against JAX's own K14, ``segment_max_grouped`` run in
  Pallas interpret mode as ``tests/test_pallas_edge_softmax.py`` runs it
  (float32; a max picks one of its inputs, so the results are equal).
- ``segment_max`` / ``segment_min`` / ``segment_softmax`` given a CSR, and
  ``aggregate_neighbors`` with max and min, against the JAX functions in
  float64 (rtol 1e-9, atol 1e-10: only the softmax's sums differ in order),
  forward and gradients, with rows that have no entries and with ties.
- Each case by two routes on the CPU: ``plain`` (PyTorch's scatter over
  ids) and ``kernels`` (``ops.segment._kernel_route`` patched to True sends
  CPU tensors through ``SegmentMaxFunction``, the autograd function the
  card uses, whose forward and backward take their plain versions on CPU
  tensors).
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu.ops import segment as jseg  # noqa: E402
from graphneuralnetworks_tpu.ops.msgpass import \
    aggregate_neighbors as j_aggregate  # noqa: E402
from graphneuralnetworks_tpu.ops.pallas.edge_softmax import \
    segment_max_grouped  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as tseg  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import segment as K  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.msgpass import \
    aggregate_neighbors as t_aggregate  # noqa: E402
from torch_parity import F64_TOL, graph_pair, pad_rows, t  # noqa: E402


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tseg, "_kernel_route", lambda t: True)
    return request.param


def _csr_inputs(seed, width, n_seg=12, n_rows=60, grid=None):
    """Sorted ids over ``n_seg`` segments, 3 and 7 empty, and data whose
    values sit on a grid of ``grid`` (ties) or are continuous."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice([i for i in range(n_seg) if i not in (3, 7)],
                             n_rows))
    shape = (n_rows,) if width is None else (n_rows, width)
    data = rng.standard_normal(shape)
    if grid is not None:
        data = np.round(data * grid) / grid
    indptr = np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n_seg))])
    cot = rng.standard_normal((n_seg,) + shape[1:])
    return ids, data, torch.tensor(indptr, dtype=torch.int32), cot


@pytest.mark.parametrize("heads", [1, 3])
def test_k14_matches_pallas_segment_max_grouped(route, heads):
    """JAX's K14 over the receiver grouping of a graph with padding, against
    the port's segment max over its receiver CSR, on the real rows."""
    jg = jgnn.rand_graph(200, 800, seed=0, build_spmm_aux=True)
    tg = tgnn.rand_graph(200, 800, seed=0, device="cpu")
    np.testing.assert_array_equal(np.asarray(jg.receivers)[:800],
                                  tg.receivers.numpy())
    rng = np.random.default_rng(1)
    lg = rng.standard_normal((800, heads)).astype(np.float32)
    lg_pad = np.full((jg.e_pad + 1, heads), -np.inf, np.float32)
    lg_pad[:800] = lg
    want = np.asarray(segment_max_grouped(jnp.asarray(lg_pad),
                                          jg.spmm_aux[0], jg.n_pad,
                                          interpret=True))[:200]
    got = tseg.segment_max(torch.tensor(lg), tg.receivers, 200,
                           empty_value=None, indptr=tg.indptr_r)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.segment_max_csr(tg.indptr_r,
                                                    torch.tensor(lg)).numpy(),
                                  want)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("width", [None, 1, 4])
@pytest.mark.parametrize("grid", [None, 2])
def test_segment_extreme_with_csr_matches_jax(route, op, width, grid):
    """Forward and gradient, empty segments (0) and, on a coarse grid,
    ties (the cotangent split evenly, as jax.grad splits it)."""
    ids, data, indptr, cot = _csr_inputs(0, width, grid=grid)
    jfn = getattr(jseg, f"segment_{op}")
    tfn = getattr(tseg, f"segment_{op}")

    def jloss(d):
        out = jfn(d, jnp.asarray(ids), 12)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    td = t(data, grad=True)
    tout = tfn(td, torch.tensor(ids), 12, indptr=indptr)
    (tout * t(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F64_TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad), **F64_TOL)
    assert np.all(tout.detach().numpy()[[3, 7]] == 0)
    if grid is not None:   # the grid does make ties
        assert len(np.unique(data)) < data.size / 2


def test_tie_gradient_matches_jax_grad(route):
    """The example of a tie: values [1, 3, 3, 2, 5], ids [0, 0, 0, 1, 1],
    cotangent [1, 2] -> [0, .5, .5, 0, 2] in JAX and here."""
    v, ids = np.array([1.0, 3, 3, 2, 5]), np.array([0, 0, 0, 1, 1])
    jgrad = jax.grad(lambda a: jnp.sum(jax.ops.segment_max(
        a, jnp.asarray(ids), 2) * jnp.array([1.0, 2.0])))(jnp.asarray(v))
    tv = t(v, grad=True)
    out = tseg.segment_max(tv, torch.tensor(ids), 2,
                           indptr=torch.tensor([0, 3, 5], dtype=torch.int32))
    (out * t([1.0, 2.0])).sum().backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tv.grad.numpy(), [0, 0.5, 0.5, 0, 2])


@pytest.mark.parametrize("op_min", [False, True])
def test_nan_propagates_like_jax(op_min):
    """An entry that is NaN makes its segment's output NaN (jnp.maximum
    and torch.amax do; CUDA's fmaxf would drop it), by both the plain
    version and the kernel route; its entries get no gradient there."""
    v = np.array([[1.0, 2.0], [np.nan, 3.0], [3.0, 1.0], [2.0, 0.0],
                  [5.0, 5.0]])
    ids = np.array([0, 0, 0, 2, 2])
    indptr = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    jfn = jax.ops.segment_min if op_min else jax.ops.segment_max
    want = np.asarray(jfn(jnp.asarray(v), jnp.asarray(ids), 3))
    plain = (K.segment_min_plain if op_min else K.segment_max_plain)(
        indptr, t(v))
    tv = t(v, grad=True)
    out = K.SegmentMaxFunction.apply(tv, indptr, op_min)
    for got in (plain, out):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    out[torch.isfinite(out)].sum().backward()
    assert torch.all(tv.grad[:3, 0] == 0)     # the NaN output's entries
    assert torch.isfinite(tv.grad).all()


def test_bwd_plain_matches_loop():
    ids, data, indptr, cot = _csr_inputs(5, 3, grid=1)
    out = K.segment_max_plain(indptr, t(data))
    got = K.segment_max_bwd_plain(indptr, t(data), out, t(cot)).numpy()
    want = np.zeros_like(data)
    o = out.numpy()
    for e, r in enumerate(ids):
        for f in range(data.shape[1]):
            hits = np.sum(data[ids == r, f] == o[r, f])
            if data[e, f] == o[r, f]:
                want[e, f] = cot[r, f] / hits
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [None, 2])
def test_segment_softmax_matches_jax(route, width):
    ids, data, indptr, cot = _csr_inputs(3, width)
    cot = np.random.default_rng(4).standard_normal(data.shape)
    mask = np.random.default_rng(5).random(len(ids)) < 0.8

    def jloss(d):
        out = jseg.segment_softmax(d, jnp.asarray(ids), 12,
                                   mask=jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    td = t(data, grad=True)
    tout = tseg.segment_softmax(td, torch.tensor(ids), 12,
                                mask=torch.tensor(mask), indptr=indptr)
    (tout * t(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F64_TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad), **F64_TOL)


@pytest.mark.parametrize("aggr", ["max", "min"])
@pytest.mark.parametrize("n_seg", [None, 45, 60])
def test_aggregate_neighbors_extreme_matches_jax(route, aggr, n_seg):
    """Messages reduced onto receivers over the receiver CSR: all rows,
    rows cut to ``num_segments`` (every receiver below it) and extended by
    rows without edges."""
    rng = np.random.default_rng(6)
    s, r = rng.integers(0, 50, 200), rng.integers(0, 40, 200)
    jg, tg = graph_pair(s, r, 50)
    m = rng.standard_normal((200, 3))
    n_out = 50 if n_seg is None else n_seg
    cot = rng.standard_normal((n_out, 3))
    order = np.argsort(r, kind="stable")   # the port's edge order

    def jloss(mm):
        out = j_aggregate(jg, aggr, mm, num_segments=jg.n_pad if n_seg is None
                          else n_seg)[:n_out]
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pad_rows(m[order], jg.e_pad)))
    tm = t(m[order], grad=True)
    tout = t_aggregate(tg, aggr, tm, num_segments=n_seg)
    (tout * t(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F64_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgrad)[:200],
                               **F64_TOL)


def test_aggregate_neighbors_cut_below_a_receiver_raises():
    rng = np.random.default_rng(7)
    _, tg = graph_pair(rng.integers(0, 30, 80), rng.integers(0, 30, 80), 30)
    with pytest.raises(ValueError, match="receiver"):
        t_aggregate(tg, "max", torch.randn(80, 2), num_segments=10)


def test_csr_size_must_match_num_segments():
    ids, data, indptr, _ = _csr_inputs(8, 2)
    with pytest.raises(ValueError, match="indptr"):
        tseg.segment_max(t(data), torch.tensor(ids), 11, indptr=indptr)


@pytest.mark.parametrize("extra", [-1, 1])
@pytest.mark.parametrize("entry", ["segment_max", "segment_softmax",
                                   "aggregate_neighbors", "reduce_nodes"])
def test_rows_must_match_the_csr(route, entry, extra):
    """Data with a row too few or too many for its grouping raises on
    either route (the kernel would read past the data or drop rows)."""
    ids, data, indptr, _ = _csr_inputs(10, 2)
    rng = np.random.default_rng(11)
    s, r = rng.integers(0, 20, 50), rng.integers(0, 20, 50)
    g = tgnn.graph(s, r, num_nodes=20, node_graph_id=np.repeat([0, 1], 10),
                   num_graphs=2, device="cpu")
    calls = {
        "segment_max": lambda n: tseg.segment_max(
            torch.randn(n, 2), torch.tensor(ids), 12, indptr=indptr),
        "segment_softmax": lambda n: tseg.segment_softmax(
            torch.randn(n, 2), torch.tensor(ids), 12, indptr=indptr),
        "aggregate_neighbors": lambda n: t_aggregate(g, "max",
                                                     torch.randn(n, 2)),
        "reduce_nodes": lambda n: tgnn.ops.gutils.reduce_nodes(
            "min", g, torch.randn(n, 2)),
    }
    n = {"segment_max": len(ids), "segment_softmax": len(ids),
         "aggregate_neighbors": 50, "reduce_nodes": 20}[entry]
    calls[entry](n)
    with pytest.raises(ValueError, match="segment ids"):
        calls[entry](n + extra)


def test_kernel_wrappers_validate_inputs():
    _, data, indptr, _ = _csr_inputs(9, 4)
    x = torch.tensor(data, dtype=torch.float32)
    with pytest.raises(TypeError):
        K._check_launch(indptr, x.double())
    with pytest.raises(TypeError):
        K._check_launch(indptr.long(), x)
    with pytest.raises(ValueError):
        K._check_launch(indptr, x.t())
    K._check_launch(indptr, x)
    # a tensor neither on the CPU nor on a CUDA card has no route
    with pytest.raises(ValueError):
        K.segment_max_csr(indptr, x.to("meta"))


def test_cpu_tensors_launch_nothing(route):
    rng = np.random.default_rng(10)
    _, tg = graph_pair(rng.integers(0, 30, 90), rng.integers(0, 30, 90), 30)
    before = dict(K.launches)
    m = torch.randn(90, 4, requires_grad=True)
    for aggr in ("max", "min"):
        t_aggregate(tg, aggr, m).sum().backward()
    tgnn.ops.softmax_edge_neighbors(tg, m).sum().backward()
    assert K.launches == before
