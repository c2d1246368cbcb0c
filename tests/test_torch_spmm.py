"""Port's SpMM (ops/cuda/spmm.py) vs graphneuralnetworks_tpu's SpMM.

Two references on purpose:

- the JAX XLA path (graphs built without ``build_spmm_aux``), float64 on
  both sides, where only summation order differs: rtol 1e-9, atol 1e-10;
- the JAX Pallas path (``build_spmm_aux=True``: the K1/K2 kernels in
  interpret mode), float32, with the JAX package's own kernel tolerances
  (tests/test_pallas_spmm.py): forward 1e-5, gradients rtol 1e-4 / atol
  1e-5. The Pallas kernel accumulates in float32 even for float64 inputs,
  which is why it is compared in float32.

Here on the CPU the port runs the kernels' plain versions; the CUDA kernels
are held to the same plain versions on the card (chip_smoke.py and
tests/test_torch_kernels.py).
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from conftest import _fixture_graphs  # noqa: E402
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402
from torch_parity import (F64_TOL, directed_graph_arrays, graph_pair,  # noqa: E402
                          pad_rows, t)

PALLAS_FWD = dict(rtol=1e-5, atol=1e-5)
PALLAS_GRAD = dict(rtol=1e-4, atol=1e-5)


def _edges(name):
    if name.startswith("fixture"):
        jg = _fixture_graphs()[int(name[-1]) - 1]
        ne = int(jg.num_edges)
        return (np.asarray(jg.senders)[:ne], np.asarray(jg.receivers)[:ne],
                int(jg.num_nodes))
    if name == "rand64":
        jg = jgnn.rand_graph(64, 512, seed=0)
        ne = int(jg.num_edges)
        return (np.asarray(jg.senders)[:ne], np.asarray(jg.receivers)[:ne],
                64)
    s, r, n, _ = directed_graph_arrays()
    return s, r, n


GRAPHS = ["fixture1", "fixture2", "rand64", "directed"]
MESSAGES = ["copy_xj", "w_mul_xj", "e_mul_xj"]


def _run_both(graph, msg, *, aux, dtype, width=5, seed=0):
    """(JAX results, port results): y, dx, dw, de on the real rows/edges."""
    s, r, n = _edges(graph)
    rng = np.random.default_rng(seed)
    ne = len(s)
    jg, tg = graph_pair(s, r, n, rng.random(ne) + 0.5, aux=aux, dtype=dtype)
    x = rng.standard_normal((n, width)).astype(dtype)
    e = (rng.random(ne) + 0.5).astype(dtype)      # in stored edge order
    cot = rng.standard_normal((n, width)).astype(dtype)
    w_stored = np.asarray(jg.edge_weight)[:ne]
    np.testing.assert_array_equal(w_stored, tg.edge_weight.numpy())

    jf, tf = getattr(jops, msg), getattr(tops, msg)

    def jloss(xp, wp, ep):
        y = jops.propagate(jf, jg.replace(edge_weight=wp), "sum", xj=xp,
                           e=ep if msg == "e_mul_xj" else None)
        return jnp.sum(y[:n] * cot), y[:n]

    (_, jy), jgr = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jnp.asarray(pad_rows(x, jg.n_pad)), jg.edge_weight,
        jnp.asarray(pad_rows(e, jg.e_pad)))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tx, tw, te = (t(x, tdt, True), t(w_stored, tdt, True), t(e, tdt, True))
    ty = tops.propagate(tf, tg.replace(edge_weight=tw), "sum", xj=tx,
                        e=te if msg == "e_mul_xj" else None)
    (ty * t(cot, tdt)).sum().backward()
    want = {"y": np.asarray(jy), "dx": np.asarray(jgr[0])[:n],
            "dw": np.asarray(jgr[1])[:ne], "de": np.asarray(jgr[2])[:ne]}
    got = {"y": ty.detach().numpy(), "dx": tx.grad.numpy(),
           "dw": None if tw.grad is None else tw.grad.numpy(),
           "de": None if te.grad is None else te.grad.numpy()}
    return want, got


def _check(want, got, msg, fwd_tol, grad_tol):
    np.testing.assert_allclose(got["y"], want["y"], **fwd_tol)
    np.testing.assert_allclose(got["dx"], want["dx"], **grad_tol)
    key = {"w_mul_xj": "dw", "e_mul_xj": "de"}.get(msg)
    if key is not None:
        np.testing.assert_allclose(got[key], want[key], **grad_tol)


@pytest.mark.parametrize("msg", MESSAGES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_propagate_sum_matches_xla_f64(graph, msg):
    want, got = _run_both(graph, msg, aux=False, dtype=np.float64)
    _check(want, got, msg, F64_TOL, F64_TOL)


@pytest.mark.parametrize("msg", MESSAGES)
@pytest.mark.parametrize("graph", ["fixture2", "rand64", "directed"])
def test_propagate_sum_matches_pallas_f32(graph, msg):
    want, got = _run_both(graph, msg, aux=True, dtype=np.float32)
    _check(want, got, msg, PALLAS_FWD, PALLAS_GRAD)


@pytest.mark.parametrize("graph", ["rand64", "directed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_function_gradcheck(graph, weighted):
    s, r, n = _edges(graph)
    g = tgnn.graph(s, r, num_nodes=n, device="cpu")
    rng = np.random.default_rng(1)
    # senders index x's rows: fewer rows than nodes is a bipartite source
    n_src = int(s.max()) + 1
    x = t(rng.standard_normal((n_src, 3)), grad=True)
    w = t(rng.random(len(s)) + 0.5, grad=True) if weighted else None

    def f(*args):
        return S.SpmmFunction.apply(args[0], args[1] if weighted else None,
                                    g.indptr_r, g.col_r, g.indptr_s, g.col_s,
                                    g.eid_s)

    assert torch.autograd.gradcheck(f, (x, w) if weighted else (x,))


@pytest.mark.parametrize("graph", GRAPHS)
def test_csr_groupings(graph):
    s, r, n = _edges(graph)
    g = tgnn.graph(s, r, num_nodes=n, device="cpu")
    ne = len(s)
    senders, receivers = g.senders.numpy(), g.receivers.numpy()
    assert np.all(np.diff(receivers) >= 0)
    # stable receiver sort: same edge multiset, ties keep input order
    order = np.argsort(r, kind="stable")
    np.testing.assert_array_equal(senders, s[order])
    for ip, key in ((g.indptr_r, receivers), (g.indptr_s, senders)):
        ip = ip.numpy()
        assert ip.dtype == np.int32 and ip.shape == (n + 1,)
        assert ip[0] == 0 and ip[-1] == ne and np.all(np.diff(ip) >= 0)
        np.testing.assert_array_equal(np.diff(ip),
                                      np.bincount(key, minlength=n))
    np.testing.assert_array_equal(g.col_r.numpy(), senders)
    eid = g.eid_s.numpy()
    np.testing.assert_array_equal(np.sort(eid), np.arange(ne))
    np.testing.assert_array_equal(g.col_s.numpy(), receivers[eid])
    assert np.all(np.diff(senders[eid]) >= 0)
    for col in (g.col_r, g.col_s, g.eid_s):
        assert col.dtype == torch.int32 and col.is_contiguous()
    assert bool(g.edge_mask.all()) and g.node_mask.shape == (n,)


@pytest.mark.parametrize("bidirected", [True, False])
def test_rand_graph_matches_jax(bidirected):
    jg = jgnn.rand_graph(64, 512, seed=5, bidirected=bidirected,
                         edge_weight=np.arange(256.0) if bidirected else None)
    tg = tgnn.rand_graph(64, 512, seed=5, bidirected=bidirected,
                         edge_weight=np.arange(256.0) if bidirected else None,
                         device="cpu")
    ne = int(jg.num_edges)
    assert tg.num_edges == ne and tg.num_nodes == 64
    np.testing.assert_array_equal(tg.senders.numpy(),
                                  np.asarray(jg.senders)[:ne])
    np.testing.assert_array_equal(tg.receivers.numpy(),
                                  np.asarray(jg.receivers)[:ne])
    if bidirected:
        np.testing.assert_array_equal(tg.edge_weight.numpy(),
                                      np.asarray(jg.edge_weight)[:ne])
