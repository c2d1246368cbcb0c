"""Graph-wise ops (``ops/gutils.py``), pooling (``models/pool.py``),
``batch`` and ``synthetic_tudataset`` vs the JAX package.

- Every ``gutils`` function and every pooling layer against JAX in float64
  (rtol 1e-9, atol 1e-10, the XLA path: only summation order differs),
  forward and the gradients of the input and of every parameter, on a
  hand-built batch of three graphs (one of them a single node without
  edges, so that a graph has no edges) and on ``batch`` of
  ``synthetic_tudataset(8)``.
- Each by two routes on the CPU: ``plain`` and ``kernels``
  (``ops.segment._kernel_route`` patched to True: the max steps go through
  ``SegmentMaxFunction`` over the batch's graph CSRs, as on the card).
- ``batch`` and ``synthetic_tudataset`` give the same arrays as JAX's.
- ``topk_index`` ties go to the lowest index, as ``jax.lax.top_k``'s do.
"""

import copy
import types

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu.data import \
    synthetic_tudataset as j_tudataset  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.data import synthetic_tudataset  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import gutils  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as tseg  # noqa: E402
from torch_parity import (F64_TOL, assert_grads_match,  # noqa: E402
                          jax_params_f64, pad_rows, port_from_jax,
                          pure_params, t)

KW = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tseg, "_kernel_route", lambda t: True)
    return request.param


def _three_graphs():
    """(senders, receivers, num_nodes) of three graphs: a directed 4-cycle
    with a chord, one node without edges, a 5-node star plus a back edge."""
    return [([0, 1, 2, 3, 0], [1, 2, 3, 0, 2], 4), ([], [], 1),
            ([0, 0, 0, 0, 4], [1, 2, 3, 4, 0], 5)]


def _batches(which):
    """The same batch in both packages: ``hand`` (three graphs, features
    from a seed) or ``tud`` (``synthetic_tudataset(8)``)."""
    rng = np.random.default_rng(0)
    if which == "hand":
        jgs, tgs = [], []
        for s, r, n in _three_graphs():
            x = rng.standard_normal((n, 3))
            e = rng.standard_normal((len(s), 2))
            jgs.append(jgnn.graph(np.asarray(s, int), np.asarray(r, int),
                                  num_nodes=n, nodes={"x": x},
                                  edges={"e": e}))
            tgs.append(tgnn.graph(np.asarray(s, int), np.asarray(r, int),
                                  num_nodes=n, nodes={"x": x},
                                  edges={"e": e}, device="cpu"))
        return jgnn.batch(jgs), tgnn.batch(tgs, device="cpu")
    jgs, _ = j_tudataset(8, seed=3)
    tgs, _ = synthetic_tudataset(8, seed=3, device="cpu")
    jb, tb = jgnn.batch(jgs), tgnn.batch(tgs, device="cpu")
    x = rng.standard_normal((tb.num_nodes, 3))
    e = rng.standard_normal((tb.num_edges, 2))
    return (jb.replace(nodes={"x": jnp.asarray(pad_rows(x, jb.n_pad))},
                       edges={"e": jnp.asarray(pad_rows(e, jb.e_pad))}),
            tb.replace(nodes={"x": t(x)}, edges={"e": t(e)}))


@pytest.fixture(params=["hand", "tud"])
def batches(request):
    return _batches(request.param)


def _check(jfn, tfn, jarg, targ, n_out, seed=1):
    """``fn(g, arg)`` forward and the gradient of ``arg`` in both packages;
    ``n_out`` real rows of the output, ``targ.shape[0]`` of the input."""
    out = np.asarray(jfn(jarg))[:n_out]
    cot = np.random.default_rng(seed).standard_normal(out.shape)
    jgrad = jax.grad(lambda a: jnp.sum(jfn(a)[:n_out] * cot))(jarg)
    ta = targ.detach().clone().requires_grad_()
    tout = tfn(ta)
    (tout * t(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), out, **F64_TOL)
    np.testing.assert_allclose(ta.grad.numpy(),
                               np.asarray(jgrad)[:targ.shape[0]], **F64_TOL)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_reduce_nodes_and_edges_match_jax(route, batches, aggr):
    jb, tb = batches
    G = tb.num_graphs
    _check(lambda a: jops.reduce_nodes(aggr, jb, a),
           lambda a: tops.reduce_nodes(aggr, tb, a), jb.x, tb.x, G)
    _check(lambda a: jops.reduce_edges(aggr, jb, a),
           lambda a: tops.reduce_edges(aggr, tb, a), jb.e, tb.e, G)


def test_softmax_and_broadcast_match_jax(route, batches):
    jb, tb = batches
    N, E, G = tb.num_nodes, tb.num_edges, tb.num_graphs
    _check(lambda a: jops.softmax_nodes(jb, a),
           lambda a: tops.softmax_nodes(tb, a), jb.x, tb.x, N)
    _check(lambda a: jops.softmax_edges(jb, a),
           lambda a: tops.softmax_edges(tb, a), jb.e, tb.e, E)
    _check(lambda a: jops.softmax_edge_neighbors(jb, a),
           lambda a: tops.softmax_edge_neighbors(tb, a), jb.e, tb.e, E)
    u = np.random.default_rng(2).standard_normal((G, 3))
    ju = jnp.asarray(pad_rows(u, jb.g_pad))
    _check(lambda a: jops.broadcast_nodes(jb, a),
           lambda a: tops.broadcast_nodes(tb, a), ju, t(u), N)
    _check(lambda a: jops.broadcast_edges(jb, a),
           lambda a: tops.broadcast_edges(tb, a), ju, t(u), E)
    np.testing.assert_array_equal(tops.edge_graph_id(tb).numpy(),
                                  np.asarray(jops.edge_graph_id(jb))[:E])


def test_batch_matches_jax():
    jb, tb = _batches("hand")
    N, E = tb.num_nodes, tb.num_edges
    assert (N, E, tb.num_graphs) == (10, 10, 3)
    for name in ("senders", "receivers"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name))[:E])
    np.testing.assert_array_equal(tb.node_graph_id.numpy(),
                                  np.asarray(jb.node_graph_id)[:N])
    np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x)[:N])
    np.testing.assert_array_equal(tb.e.numpy(), np.asarray(jb.e)[:E])
    # the graph CSRs: graph 1 has one node and no edges
    np.testing.assert_array_equal(tb.indptr_g.numpy(), [0, 4, 5, 10])
    np.testing.assert_array_equal(tb.indptr_ge.numpy(), [0, 5, 5, 10])


def test_synthetic_tudataset_and_its_batch_match_jax():
    jgs, jl = j_tudataset(8, seed=5)
    tgs, tl = synthetic_tudataset(8, seed=5, device="cpu")
    np.testing.assert_array_equal(tl, jl)
    for jg, tg in zip(jgs, tgs):
        n, e = tg.num_nodes, tg.num_edges
        assert (n, e) == (int(jg.num_nodes), int(jg.num_edges))
        for name in ("senders", "receivers"):
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(getattr(jg, name))[:e])
        np.testing.assert_array_equal(tg.x.numpy(), np.asarray(jg.x)[:n])
        np.testing.assert_array_equal(tg.globals_["y"].numpy(),
                                      np.asarray(jg.globals_["y"])[:1])
    jb, tb = jgnn.batch(jgs), tgnn.batch(tgs, device="cpu")
    N, E, G = tb.num_nodes, tb.num_edges, tb.num_graphs
    assert (N, E, G) == (int(jb.num_nodes), int(jb.num_edges), 8)
    for got, want, n in ((tb.senders, jb.senders, E),
                         (tb.receivers, jb.receivers, E),
                         (tb.x, jb.x, N), (tb.node_graph_id,
                                           jb.node_graph_id, N),
                         (tb.globals_["y"], jb.globals_["y"], G)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])


def test_unsorted_graph_ids_have_no_graph_csr():
    g = tgnn.graph([0, 1, 2], [1, 2, 0], node_graph_id=[1, 0, 1],
                   num_graphs=2, device="cpu")
    assert g.indptr_g is None and g.indptr_ge is None
    x = t(np.arange(3.0)[:, None])
    # the CPU reduces over the ids as they are
    np.testing.assert_array_equal(tops.reduce_nodes("max", g, x).numpy(),
                                  [[1.0], [2.0]])
    # a tensor on the card needs the graph CSR: raise, do not guess
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="non-decreasing"):
        gutils._graph_csr(g, g.indptr_g, on_card)
    sorted_g = tgnn.graph([0, 1, 2], [1, 2, 0], node_graph_id=[0, 0, 1],
                          num_graphs=2, device="cpu")
    np.testing.assert_array_equal(sorted_g.indptr_g.numpy(), [0, 2, 3])
    np.testing.assert_array_equal(sorted_g.indptr_ge.numpy(), [0, 2, 3])


# ---- pooling layers ---------------------------------------------------------

def _layer_case(jm, tm, jb, tb, n_out, call=lambda m, g, x: m(g, x)):
    """Forward and the gradients of ``x`` and of every parameter of a
    pooling layer (JAX weights in float64, loaded into the port)."""
    gd, params, rest = nnx.split(jm, nnx.Param, ...)
    out = np.asarray(call(jm, jb, jb.x))[:n_out]
    cot = np.random.default_rng(3).standard_normal(out.shape)

    def jloss(p, xp):
        return jnp.sum(call(nnx.merge(gd, p, rest), jb, xp)[:n_out] * cot)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jb.x)
    tx = tb.x.detach().clone().requires_grad_()
    tout = call(tm, tb, tx)
    (tout * t(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), out, **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(gx)[:tb.num_nodes], **F64_TOL)
    return jax.tree.map(np.asarray, nnx.to_pure_dict(gp))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_global_pool_matches_jax(route, batches, aggr):
    jb, tb = batches
    _layer_case(JM.GlobalPool(aggr), TM.GlobalPool(aggr), jb, tb,
                tb.num_graphs)


@pytest.mark.parametrize("with_feat", [True, False])
def test_global_attention_pool_matches_jax(route, batches, with_feat):
    jb, tb = batches
    r = nnx.Rngs(4)
    jm = jax_params_f64(JM.GlobalAttentionPool(
        nnx.Linear(3, 1, rngs=r), nnx.Linear(3, 4, rngs=r) if with_feat
        else None))
    tm = port_from_jax(TM.GlobalAttentionPool(
        torch.nn.Linear(3, 1, dtype=torch.float64),
        torch.nn.Linear(3, 4, dtype=torch.float64) if with_feat else None),
        jm)
    grads = _layer_case(jm, tm, jb, tb, tb.num_graphs)
    assert_grads_match(tm, grads, **F64_TOL)


def test_set2set_matches_jax(route, batches):
    """The LSTM query, attention and readout rounds; checks flax's gate
    order (i, f, g, o) and ``(c, h)`` carry against ``torch.nn.LSTMCell``
    through ``load_jax_params``."""
    jb, tb = batches
    jm = jax_params_f64(JM.Set2Set(3, 3, rngs=nnx.Rngs(5)))
    # random biases, so that the bias mapping is exercised too
    b = np.random.default_rng(6).standard_normal(12)
    jm.lstm.dense_h.bias[...] = jnp.asarray(b)
    tm = port_from_jax(TM.Set2Set(3, 3, **KW), jm)
    assert torch.all(tm.lstm.bias_ih == 0)
    grads = _layer_case(jm, tm, jb, tb, tb.num_graphs)
    ref = load_jax_params(copy.deepcopy(tm), grads)
    cell, want = tm.lstm, ref.lstm
    for name in ("weight_ih", "weight_hh", "bias_hh"):
        np.testing.assert_allclose(getattr(cell, name).grad.numpy(),
                                   getattr(want, name).detach().numpy(),
                                   err_msg=name, **F64_TOL)
    # both biases add to the same gates: one gradient
    np.testing.assert_array_equal(cell.bias_ih.grad.numpy(),
                                  cell.bias_hh.grad.numpy())


def test_topk_pool_matches_jax(batches):
    """On the batch as one graph: score, top-k (distinct scores), gating."""
    jb, tb = batches
    jm = jax_params_f64(JM.TopKPool(3, 4, rngs=nnx.Rngs(7)))
    tm = port_from_jax(TM.TopKPool(3, 4, **KW), jm)
    jx, jidx = jm(jb, jb.x)
    tx, tidx = tm(tb, tb.x)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    grads = _layer_case(jm, tm, jb, tb, 4, call=lambda m, g, x: m(g, x)[0])
    assert_grads_match(tm, grads, **F64_TOL)


def test_topk_index_matches_jax_with_ties():
    """The vector form and the per-graph form; tied scores go to the lowest
    index first, as ``jax.lax.top_k`` breaks ties."""
    jb, tb = _batches("tud")
    N, G = tb.num_nodes, tb.num_graphs
    # + 0.0 turns np.round's -0.0 into 0.0, which jax.lax.top_k ranks above
    # -0.0 and a sort takes as equal
    y = np.round(np.random.default_rng(8).standard_normal(N) * 2) / 2 + 0.0
    assert len(np.unique(y)) < N / 4                # many ties
    jv, ji = JM.topk_index(jnp.asarray(y), 7)
    tv, ti = TM.topk_index(t(y), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jv, ji = JM.topk_index(jnp.asarray(pad_rows(y, jb.n_pad)), 5, g=jb)
    tv, ti = TM.topk_index(t(y), 5, g=tb)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:G])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[:G])
    with pytest.raises(ValueError):
        TM.topk_index(t(y)[:, None], 3)


def test_pool_params_load_from_jax():
    """``load_jax_params`` names for the pooling layers and EdgeConv."""
    r = nnx.Rngs(9)
    pairs = [
        (JM.TopKPool(5, 2, rngs=r), TM.TopKPool(5, 2, **KW)),
        (JM.Set2Set(4, 2, rngs=r), TM.Set2Set(4, 2, **KW)),
        (JM.GlobalAttentionPool(nnx.Linear(4, 1, rngs=r),
                                nnx.Linear(4, 3, rngs=r)),
         TM.GlobalAttentionPool(torch.nn.Linear(4, 1, dtype=torch.float64),
                                torch.nn.Linear(4, 3, dtype=torch.float64))),
        (JM.EdgeConv(JM.MLP([8, 6, 3], rngs=r)),
         TM.EdgeConv(TM.MLP([8, 6, 3], **KW))),
    ]
    for jm, tm in pairs:
        params = pure_params(jax_params_f64(jm))
        load_jax_params(tm, params)
        n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(params))
        n_port = sum(p.numel() for p in tm.parameters())
        extra = tm.lstm.bias_ih.numel() if isinstance(tm, TM.Set2Set) else 0
        assert n_port == n_jax + extra, type(tm).__name__
