"""Port's propagate / apply_edges / aggregate_neighbors vs the JAX package.

float64 against the JAX XLA path (rtol 1e-9, atol 1e-10): every message of
the vocabulary under sum, mean and max, forward and the gradients with
respect to every input, on a directed weighted graph with isolated nodes.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402
from torch_parity import (F64_TOL, directed_graph_arrays, graph_pair,  # noqa: E402
                          pad_rows, t)

MESSAGES = ["copy_xj", "copy_xi", "xi_dot_xj", "xi_sub_xj", "xj_sub_xi",
            "e_mul_xj", "e_mul_xj_2d", "w_mul_xj"]
WIDTH = 4


def _setup(seed=0):
    s, r, n, w = directed_graph_arrays(seed=seed)
    jg, tg = graph_pair(s, r, n, w)
    rng = np.random.default_rng(seed + 10)
    ne = len(s)
    xi = rng.standard_normal((n, WIDTH))
    xj = rng.standard_normal((n, WIDTH))
    e1 = rng.random(ne) + 0.5
    e2 = rng.standard_normal((ne, WIDTH))
    return jg, tg, n, ne, xi, xj, e1, e2


def _fn(msg, pkg):
    return getattr(pkg, "e_mul_xj" if msg == "e_mul_xj_2d" else msg)


@pytest.mark.parametrize("msg", MESSAGES)
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_propagate_matches_jax(aggr, msg):
    jg, tg, n, ne, xi, xj, e1, e2 = _setup()
    e = e2 if msg == "e_mul_xj_2d" else e1
    use_e = msg.startswith("e_mul")
    out_w = 1 if msg == "xi_dot_xj" else WIDTH
    cot = np.random.default_rng(5).standard_normal((n, out_w))

    def jloss(a, b, c):
        y = jops.propagate(_fn(msg, jops), jg, aggr, xi=a, xj=b,
                           e=c if use_e else None)
        return jnp.sum(y[:n] * cot), y[:n]

    (_, jy), jgr = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jnp.asarray(pad_rows(xi, jg.n_pad)),
        jnp.asarray(pad_rows(xj, jg.n_pad)),
        jnp.asarray(pad_rows(e, jg.e_pad)))
    a, b, c = t(xi, grad=True), t(xj, grad=True), t(e, grad=True)
    y = tops.propagate(_fn(msg, tops), tg, aggr, xi=a, xj=b,
                       e=c if use_e else None)
    (y * t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F64_TOL)
    for got, want, rows in ((a, jgr[0], n), (b, jgr[1], n), (c, jgr[2], ne)):
        # an input the message ignores gets no gradient here, zeros in JAX
        grad = (np.zeros(tuple(got.shape)) if got.grad is None
                else got.grad.numpy())
        np.testing.assert_allclose(grad, np.asarray(want)[:rows], **F64_TOL)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_apply_edges_then_aggregate(aggr):
    jg, tg, n, ne, xi, xj, _, e2 = _setup(seed=1)

    def msg(a, b, e):
        return {"m": a * b + e, "k": b}

    jm = jops.apply_edges(msg, jg, xi=jnp.asarray(pad_rows(xi, jg.n_pad)),
                          xj=jnp.asarray(pad_rows(xj, jg.n_pad)),
                          e=jnp.asarray(pad_rows(e2, jg.e_pad)))
    tm = tops.apply_edges(msg, tg, xi=t(xi), xj=t(xj), e=t(e2))
    for k in ("m", "k"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k])[:ne],
                                   **F64_TOL)
    ja = jops.aggregate_neighbors(jg, aggr, jm)
    ta = tops.aggregate_neighbors(tg, aggr, tm)
    for k in ("m", "k"):
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k])[:n],
                                   **F64_TOL)


def test_endpoint_gather_backward_is_the_spmm():
    """apply_edges' node gathers take K1 as their backward: the gradient
    equals a scatter-add and, on the CPU, no kernel is launched."""
    _, tg, n, ne, xi, xj, _, _ = _setup(seed=2)
    cot = np.random.default_rng(3).standard_normal((ne, WIDTH))
    a, b = t(xi, grad=True), t(xj, grad=True)
    before = dict(S.launches)
    m = tops.apply_edges(tops.xi_sub_xj, tg, xi=a, xj=b)
    (m * t(cot)).sum().backward()
    assert S.launches == before
    r, s = tg.receivers.numpy(), tg.senders.numpy()
    want_a = np.zeros((n, WIDTH))
    np.add.at(want_a, r, cot)
    want_b = np.zeros((n, WIDTH))
    np.add.at(want_b, s, -cot)
    np.testing.assert_allclose(a.grad.numpy(), want_a, **F64_TOL)
    np.testing.assert_allclose(b.grad.numpy(), want_b, **F64_TOL)


def test_mean_takes_the_spmm_at_any_size(monkeypatch):
    """Mean of copy_xj is SpMM sum / true in-degree with no size gate."""
    _, tg, n, _, _, xj, _, _ = _setup(seed=4)
    calls = []
    spmm_csr = S.spmm_csr
    monkeypatch.setattr(S, "spmm_csr",
                        lambda *a: calls.append(1) or spmm_csr(*a))
    y = tops.propagate(tops.copy_xj, tg, "mean", xj=t(xj))
    assert calls == [1]
    deg = np.bincount(tg.receivers.numpy(), minlength=n)
    ssum = np.zeros((n, WIDTH))
    np.add.at(ssum, tg.receivers.numpy(), xj[tg.senders.numpy()])
    np.testing.assert_allclose(y.numpy(), ssum / np.maximum(deg, 1)[:, None],
                               **F64_TOL)
    assert np.all(y.numpy()[deg == 0] == 0)
