"""Port's ``query`` and ``GraphTuple.reverse`` vs graphneuralnetworks_tpu.

- Every ``query`` function against the JAX package's, on a directed
  weighted multigraph with isolated nodes and on a batch of three graphs
  (float64; the JAX side's padded rows dropped). ``laplacian_lambda_max``
  and ``scaled_laplacian`` run power iterations from other start vectors
  on the two sides: they are held to ``numpy.linalg.eigvalsh`` in
  ``tests/test_torch_cheb.py``.
- ``reverse``: ``apply_edges`` and ``propagate`` (``copy_xj``,
  ``w_mul_xj`` with the graph's weights and with weights in the original
  edge order, ``e_mul_xj`` and a mean) with every gradient, and
  ``aggregate_neighbors`` (sum, mean, max on the CPU) on a reversed graph
  against JAX's reversed graph; the groupings it swaps; ``degree`` with the
  directions swapped; ``sorted_by_receivers``.
- The routes that read edge arrays in receiver-CSR order (K14 under
  ``aggregate_neighbors`` and ``softmax_edge_neighbors``, the attention
  kernels, K13 under ``apply_edges(xi_dot_xj)``) on a reversed graph
  against JAX's, each by its plain route and by its kernel route (the
  card's autograd functions on CPU tensors).
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import msgpass as TMP  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as TS  # noqa: E402
from torch_parity import (F64_TOL, directed_graph_arrays, graph_pair,  # noqa: E402
                          pad_rows, route_parity, t)


def _batch_pair():
    """Three graphs of 7, 12 and 9 nodes (one with an isolated node and a
    self-loop) as one batch in both packages, with edge weights."""
    rng = np.random.default_rng(31)
    sizes, parts = (7, 12, 9), []
    off = 0
    for i, n in enumerate(sizes):
        e = 3 * n
        s, r = rng.integers(0, n - (i == 0), e), rng.integers(0, n - (i == 0),
                                                              e)
        if i == 1:
            s[0] = r[0] = 3
        parts.append((s + off, r + off))
        off += n
    s = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    w = rng.random(len(s)) + 0.5
    gid = np.repeat(np.arange(3), sizes)
    jg = jgnn.graph(s, r, num_nodes=off, edge_weight=w, node_graph_id=gid,
                    num_graphs=3)
    tg = tgnn.graph(s, r, num_nodes=off, edge_weight=w, node_graph_id=gid,
                    num_graphs=3, device="cpu")
    return jg, tg


def _pairs():
    s, r, n, w = directed_graph_arrays(seed=30)
    return {"single": graph_pair(s, r, n, w), "batch": _batch_pair()}


def _same(a, b, n=None):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if n is not None:
        b = b[tuple(slice(0, n) for _ in range(b.ndim))]
    np.testing.assert_allclose(a, b, **F64_TOL)


@pytest.mark.parametrize("which", ["single", "batch"])
def test_dense_queries_match_jax(which):
    jg, tg = _pairs()[which]
    n = tg.num_nodes
    f64 = dict(dtype=jnp.float64), dict(dtype=torch.float64)
    for weighted in (True, False):
        _same(tgnn.adjacency_matrix(tg, weighted=weighted, **f64[1]),
              jgnn.adjacency_matrix(jg, weighted=weighted, **f64[0]), n)
    for d in ("out", "in", "both"):
        _same(tgnn.laplacian_matrix(tg, dir=d, **f64[1]),
              jgnn.laplacian_matrix(jg, dir=d, **f64[0]), n)
        _same(tgnn.degree(tg, dir=d, **f64[1]),
              jgnn.degree(jg, dir=d, **f64[0])[:n])
    for loops in (False, True):
        _same(tgnn.normalized_adjacency(tg, add_self_loops=loops, **f64[1]),
              jgnn.normalized_adjacency(jg, add_self_loops=loops, **f64[0]),
              n)
        _same(tgnn.normalized_laplacian(tg, add_self_loops=loops, **f64[1]),
              jgnn.normalized_laplacian(jg, add_self_loops=loops, **f64[0]),
              n)
    for k in (1, 2, 3):
        _same(tgnn.khop_adj(tg, k, **f64[1]), jgnn.khop_adj(jg, k, **f64[0]),
              n)
    assert tgnn.adjacency_matrix(tg).dtype == torch.float32


def test_adjacency_matrix_gradient_reaches_edge_weights():
    s, r, n, w = directed_graph_arrays(seed=32)
    jg, tg = graph_pair(s, r, n, w)
    rng = np.random.default_rng(32)
    cot = rng.standard_normal((n, n))
    tw = t(tg.edge_weight.numpy(), grad=True)
    (tgnn.adjacency_matrix(tg.replace(edge_weight=tw), dtype=torch.float64)
     * t(cot)).sum().backward()
    jgw = jax.grad(lambda wp: jnp.sum(jgnn.adjacency_matrix(
        jg.replace(edge_weight=wp), dtype=jnp.float64)[:n, :n] * cot))(
        jg.edge_weight)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw)[:len(s)],
                               **F64_TOL)


@pytest.mark.parametrize("which", ["single", "batch"])
def test_predicates_and_getters_match_jax(which):
    jg, tg = _pairs()[which]
    n, ne = tg.num_nodes, tg.num_edges
    np.testing.assert_array_equal(tgnn.graph_indicator(tg).numpy(),
                                  np.asarray(jgnn.graph_indicator(jg))[:n])
    np.testing.assert_array_equal(
        tgnn.graph_indicator(tg, edges=True).numpy(),
        np.asarray(jgnn.graph_indicator(jg, edges=True))[:ne])
    for fn in (jgnn.has_self_loops, jgnn.has_multi_edges,
               jgnn.is_bidirected):
        got = getattr(tgnn, fn.__name__)(tg)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
        assert bool(got) == bool(fn(jg)), fn.__name__
    for d in ("out", "in"):
        assert bool(tgnn.has_isolated_nodes(tg, dir=d)) == bool(
            jgnn.has_isolated_nodes(jg, dir=d))
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    for i, j in [(s[0], r[0]), (s[-1], r[-1]), (0, n - 1), (n - 1, 0)]:
        assert bool(tgnn.has_edge(tg, int(i), int(j))) == bool(
            jgnn.has_edge(jg, int(i), int(j)))
    assert tgnn.is_directed(tg) is jgnn.is_directed(jg) is True
    assert tgnn.get_graph_type(tg) == jgnn.get_graph_type(jg) == "coo"
    for d in ("out", "in"):
        assert tgnn.adjacency_list(tg, dir=d) == jgnn.adjacency_list(jg,
                                                                     dir=d)
    for i in range(n):
        assert tgnn.outneighbors(tg, i) == jgnn.outneighbors(jg, i)
        assert tgnn.inneighbors(tg, i) == jgnn.inneighbors(jg, i)


def test_predicates_on_simple_graphs_match_jax():
    """The predicates' other answers: a bidirected graph without self-loops
    or multi-edges, and a path (directed, no isolated node out-wise but an
    in-wise one)."""
    cases = [(np.array([0, 1, 1, 2, 2, 0]), np.array([1, 0, 2, 1, 0, 2]), 3),
             (np.array([0, 1, 2]), np.array([1, 2, 3]), 4)]
    for s, r, n in cases:
        jg, tg = graph_pair(s, r, n)
        for name in ("has_self_loops", "has_multi_edges", "is_bidirected"):
            assert bool(getattr(tgnn, name)(tg)) == bool(
                getattr(jgnn, name)(jg)), name
        for d in ("out", "in"):
            assert bool(tgnn.has_isolated_nodes(tg, dir=d)) == bool(
                jgnn.has_isolated_nodes(jg, dir=d))
    assert bool(tgnn.is_bidirected(graph_pair(*cases[0])[1]))
    assert not bool(tgnn.is_bidirected(graph_pair(*cases[1])[1]))


def test_feature_getters_match_jax():
    s, r, n, _ = directed_graph_arrays(seed=33)
    rng = np.random.default_rng(33)
    x, e = rng.standard_normal((n, 3)), rng.standard_normal((len(s), 2))
    u = rng.standard_normal((1, 4))
    jg = jgnn.graph(s, r, num_nodes=n, nodes=x, edges=e, globals_=u)
    tg = tgnn.graph(s, r, num_nodes=n, nodes=x, edges=e, globals_=u,
                    device="cpu")
    np.testing.assert_array_equal(tgnn.node_features(tg).numpy(),
                                  np.asarray(jgnn.node_features(jg))[:n])
    np.testing.assert_array_equal(tgnn.edge_features(tg).numpy(),
                                  np.asarray(jgnn.edge_features(jg))[
                                      :len(s)])
    np.testing.assert_array_equal(tgnn.graph_features(tg).numpy(),
                                  np.asarray(jgnn.graph_features(jg)))
    two = tg.with_nodes(y=torch.zeros(n))
    assert set(tgnn.node_features(two)) == {"x", "y"}
    bare = tgnn.graph(s, r, num_nodes=n, device="cpu")
    jbare = jgnn.graph(s, r, num_nodes=n)
    for name in ("node_features", "edge_features", "graph_features"):
        assert getattr(tgnn, name)(bare) is None
        assert getattr(jgnn, name)(jbare) is None


@pytest.mark.parametrize("n,raises", [(46335, False), (46336, True)])
def test_dense_size_guard_matches_jax(n, raises):
    """The JAX package refuses a dense query when its padded node count
    round_up(N + 1, 8) exceeds 46341; the port refuses the same N."""
    from graphneuralnetworks_tpu_torch import query as TQ
    s, r = np.array([0, 1]), np.array([1, 0])
    tg = tgnn.graph(s, r, num_nodes=n, device="cpu")
    jg = jgnn.graph(s, r, num_nodes=n)
    assert (jg.n_pad > 46341) is raises
    if raises:
        with pytest.raises(ValueError, match="dense"):
            tgnn.adjacency_matrix(tg)
        with pytest.raises(ValueError):
            jgnn.adjacency_matrix(jg)
    else:
        TQ._check_dense(tg, "adjacency_matrix")     # no [N, N] built here


# ---- reverse ----------------------------------------------------------------

def test_reverse_swaps_the_groupings():
    s, r, n, w = directed_graph_arrays(seed=34)
    _, tg = graph_pair(s, r, n, w)
    gr = tg.reverse()
    assert gr.senders is tg.receivers and gr.receivers is tg.senders
    assert gr.indptr_r is tg.indptr_s and gr.col_r is tg.col_s
    assert gr.eid_r is tg.eid_s and gr.eid_s is None
    assert gr.indptr_s is tg.indptr_r and gr.col_s is tg.col_r
    assert gr.edge_weight is tg.edge_weight
    back = gr.reverse()
    for name in ("senders", "receivers", "indptr_r", "col_r", "eid_r",
                 "indptr_s", "col_s", "eid_s"):
        assert getattr(back, name) is getattr(tg, name), name
    # the reversed receiver CSR, read through eid_r, groups edge ids by
    # their new receiver
    pos = np.arange(gr.num_edges)
    rows = np.repeat(np.arange(n), np.diff(gr.indptr_r.numpy()))
    eid = gr.eid_r.numpy()
    np.testing.assert_array_equal(gr.receivers.numpy()[eid], rows)
    np.testing.assert_array_equal(gr.senders.numpy()[eid],
                                  gr.col_r.numpy()[pos])
    assert gr.to("cpu").eid_s is None


def test_sorted_by_receivers_after_reverse():
    """True for a built graph, False after reverse (as JAX's ``reverse``
    sets it), True again after a second reverse; read-only."""
    s, r, n, _ = directed_graph_arrays(seed=35)
    jg, tg = graph_pair(s, r, n)
    assert tg.sorted_by_receivers is True
    assert tg.reverse().sorted_by_receivers is False
    assert jg.reverse().sorted_by_receivers is False
    assert tg.reverse().reverse().sorted_by_receivers is True
    with pytest.raises(AttributeError):
        tg.reverse().sorted_by_receivers = True


@pytest.mark.parametrize("weighted", [False, True])
def test_degree_of_reverse_swaps_directions(weighted):
    s, r, n, w = directed_graph_arrays(seed=36)
    jg, tg = graph_pair(s, r, n, w if weighted else None)
    swap = {"out": "in", "in": "out", "both": "both"}
    for d in ("out", "in", "both"):
        got = tgnn.degree(tg.reverse(), dir=d, dtype=torch.float64)
        np.testing.assert_allclose(
            got.numpy(), tgnn.degree(tg, dir=swap[d],
                                     dtype=torch.float64).numpy(),
            **F64_TOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jgnn.degree(jg.reverse(), dir=d,
                                                dtype=jnp.float64))[:n],
            **F64_TOL)


def _msg(xi, xj, e):
    return jnp.tanh(xi) * xj + e[:, None] if isinstance(xi, jax.Array) \
        else torch.tanh(xi) * xj + e[:, None]


# name: (message, aggregation, passes the weights as e, reads xi)
PROPAGATE = {
    "copy_xj": ("copy_xj", "sum", False, False),
    "copy_xj_mean": ("copy_xj", "mean", False, False),
    "w_mul_xj_graph_weights": ("w_mul_xj", "sum", False, False),
    "w_mul_xj_explicit": ("w_mul_xj", "sum", True, False),
    "e_mul_xj": ("e_mul_xj", "sum", True, False),
    "gathered_mean": (None, "mean", True, True),
    "gathered_max": (None, "max", True, True),
}


@pytest.mark.parametrize("name", list(PROPAGATE))
def test_propagate_on_reverse_matches_jax(name):
    """``propagate`` over the reversed graph with every gradient: the SpMM
    route reads the weights (in the original edge order) through
    ``eid_r``; the gathered messages' receiver gather takes its backward
    through it too."""
    fname, aggr, pass_e, with_xi = PROPAGATE[name]
    s, r, n, w = directed_graph_arrays(seed=37)
    jg, tg = graph_pair(s, r, n, w)
    jr, tr = jg.reverse(), tg.reverse()
    ne = len(s)
    rng = np.random.default_rng(37)
    x, ew = rng.standard_normal((n, 4)), rng.random(ne) + 0.5
    cot = rng.standard_normal((n, 4))

    def jfun(xp, wp):
        f = _msg if fname is None else getattr(jops, fname)
        y = jops.propagate(f, jr, aggr, xi=xp if with_xi else None, xj=xp,
                           e=wp if pass_e else None)[:n]
        return jnp.sum(y * cot), y

    (_, jy), (gx, gw) = jax.value_and_grad(jfun, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(pad_rows(x, jg.n_pad)), jnp.asarray(pad_rows(ew,
                                                                 jg.e_pad)))
    tx, tw = t(x, grad=True), t(ew, grad=True)
    f = _msg if fname is None else getattr(tops, fname)
    ty = tops.propagate(f, tr, aggr, xi=tx if with_xi else None, xj=tx,
                        e=tw if pass_e else None)
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx)[:n],
                               **F64_TOL)
    if pass_e:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw)[:ne],
                                   **F64_TOL)


def test_apply_edges_on_reverse_matches_jax():
    """Endpoint gathers of a reversed graph, per edge in the original edge
    order, and their gradients (the receiver side's backward is K1's plain
    version over the reversed receiver CSR through ``eid_r``)."""
    s, r, n, _ = directed_graph_arrays(seed=38)
    jg, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(38)
    xi, xj = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    e = rng.standard_normal(len(s))
    cot = rng.standard_normal((len(s), 3))

    def jfun(a, b):
        m = jops.apply_edges(_msg, jg.reverse(), a, b,
                             jnp.asarray(pad_rows(e, jg.e_pad)))
        return jnp.sum(m[:len(s)] * cot), m[:len(s)]

    (_, jm), (ga, gb) = jax.value_and_grad(jfun, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(pad_rows(xi, jg.n_pad)), jnp.asarray(pad_rows(xj,
                                                                  jg.n_pad)))
    ta, tb = t(xi, grad=True), t(xj, grad=True)
    tm = tops.apply_edges(_msg, tg.reverse(), ta, tb, t(e))
    (tm * t(cot)).sum().backward()
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm),
                               **F64_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga)[:n],
                               **F64_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb)[:n],
                               **F64_TOL)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_aggregate_neighbors_on_reverse_matches_jax(aggr):
    """Edge messages in the original edge order reduced onto the reversed
    graph's receivers (the CPU route: segment ops over receiver ids)."""
    s, r, n, _ = directed_graph_arrays(seed=39)
    jg, tg = graph_pair(s, r, n)
    m = np.random.default_rng(39).standard_normal((len(s), 3))
    jy = jops.aggregate_neighbors(jg.reverse(), aggr,
                                  jnp.asarray(pad_rows(m, jg.e_pad)))
    ty = tops.aggregate_neighbors(tg.reverse(), aggr, t(m))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:n], **F64_TOL)


# ---- the routes that read edge arrays in receiver-CSR order ----------------

H, DH = 2, 3


def _jax_ops():
    """The JAX package's ops with its attention functions beside them."""
    from types import SimpleNamespace
    from graphneuralnetworks_tpu.ops import attention
    return SimpleNamespace(**{**vars(jops), **vars(attention)})


def _rev_routes(ops):
    """name -> (function of the graph and the inputs, the inputs' (kind,
    shape) with ``n`` and ``e`` the graph's counts, the port module whose
    ``_kernel_route`` sends CPU tensors through the card's route)."""
    def n(*tail):
        return ("node", tail)

    def e(*tail):
        return ("edge", tail)
    return {
        "aggregate_neighbors_max": (
            lambda g, m: ops.aggregate_neighbors(g, "max", m),
            [e(DH)], TS),
        "aggregate_neighbors_min_dict": (
            lambda g, m: ops.aggregate_neighbors(g, "min", {"a": m})["a"],
            [e(DH)], TS),
        "softmax_edge_neighbors": (ops.softmax_edge_neighbors, [e(H)], TS),
        "gat_attention": (
            lambda g, pi, pj, v: ops.gat_attention(g, pi, pj, v, 0.2),
            [n(H), n(H), n(H, DH)], TA),
        "gatv2_attention": (
            lambda g, q, k, a: ops.gatv2_attention(g, q, k, a, 0.2),
            [n(H, DH), n(H, DH), ("dense", (DH, H))], TA),
        "dot_attention": (
            lambda g, q, k, v: ops.dot_attention(g, q, k, v, 0.5),
            [n(H, DH), n(H, DH), n(H, DH)], TA),
        "attention_aggregate_edge_values": (
            ops.attention_aggregate, [e(H), e(H, DH)], TA),
        "attention_aggregate_node_values": (
            lambda g, lg, v: ops.attention_aggregate(g, lg, v,
                                                     node_values=True),
            [e(H), n(H, DH)], TA),
        "dot_attention_logits": (ops.dot_attention_logits,
                                 [n(H, DH), n(H, DH)], TA),
        "apply_edges_xi_dot_xj": (
            lambda g, a, b: ops.apply_edges(ops.xi_dot_xj, g, a, b),
            [n(DH), n(DH)], TMP),
    }


@pytest.mark.parametrize("name", list(_rev_routes(tops)))
def test_receiver_order_routes_raise_on_reverse(monkeypatch, name):
    """Each route that reads edge arrays by receiver-CSR position (K14
    under ``aggregate_neighbors`` and ``softmax_edge_neighbors``, the
    attention kernels K3-K12, K13 under ``dot_attention_logits`` and
    ``apply_edges(xi_dot_xj)``) answers on a reversed graph, whose
    receiver-CSR positions are not edge ids, and matches JAX's reversed
    graph in float64, output and every gradient: by its plain route and by
    the card's route (``graph.csr_view``'s edge-id map; the kernels' plain
    versions on CPU tensors). No ``ValueError`` naming ``reverse`` is
    left."""
    s, r, n, _ = directed_graph_arrays(seed=40)
    jg, tg = graph_pair(s, r, n)
    tfn, specs, module = _rev_routes(tops)[name]
    jfn = _rev_routes(_jax_ops())[name][0]
    rng = np.random.default_rng(40)
    sizes = {"node": n, "edge": len(s)}
    inputs = [(k, rng.standard_normal((sizes.get(k, 0),) * (k in sizes)
                                      + shape)) for k, shape in specs]
    route_parity(jfn, tfn, jg.reverse(), tg.reverse(), inputs,
                 kernel_patches=(module,), monkeypatch=monkeypatch)
