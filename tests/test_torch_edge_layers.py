"""The port's edge-featured layers vs graphneuralnetworks_tpu/models/conv.py.

NNConv, CGConv, GMMConv (both ``reference_exact`` settings), MEGNetConv and
EGNNConv are built in both packages at the JAX tests' shapes (``IN, OUT,
EIN = 4, 5, 3``, tests/test_conv_layers.py:18), the JAX weights (cast to
float64) copied into the port with ``load_jax_params``, and the forward
outputs (both of MEGNet's and EGNN's) and the gradients of every parameter
and every input (node features, edge features, positions) compared in
float64 (XLA path: rtol 1e-9, atol 1e-10). Each case runs on a directed
multigraph with isolated nodes and on the reference's two 4-node test
graphs (one with an isolated vertex). The directed graph keeps its five
self-loops, except for EGNN: its ``sqrt(|x_i - x_j|^2)`` has no gradient at
0, in either package.
"""

import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from torch_parity import (F64_TOL, assert_grads_match,  # noqa: E402
                          directed_graph_arrays, graph_pair, jax_params_f64,
                          pad_rows, port_from_jax, t)

IN, OUT, EIN = 4, 5, 3
KW = dict(device="cpu", dtype=torch.float64)
softplus_t = torch.nn.functional.softplus

# name: (JAX layer, port layer, node input width, edge input width (0:
# none), each output's rows ("n": nodes, "e": edges)); the EGNN cases
# (egnn*) also take positions [N, 3]
CASES = {
    "nnconv_sum": (
        lambda r: JM.NNConv(IN, OUT, JM.MLP([EIN, IN * OUT], rngs=r),
                            jnp.tanh, rngs=r),
        lambda: TM.NNConv(IN, OUT, TM.MLP([EIN, IN * OUT], **KW),
                          torch.tanh, **KW), IN, EIN, "n"),
    "nnconv_mean": (
        lambda r: JM.NNConv(IN, OUT, JM.MLP([EIN, 6, IN * OUT], rngs=r),
                            jnp.tanh, aggr="mean", rngs=r),
        lambda: TM.NNConv(IN, OUT, TM.MLP([EIN, 6, IN * OUT], **KW),
                          torch.tanh, aggr="mean", **KW), IN, EIN, "n"),
    "cgconv": (lambda r: JM.CGConv(IN, OUT, rngs=r),
               lambda: TM.CGConv(IN, OUT, **KW), IN, 0, "n"),
    "cgconv_e_softplus": (
        lambda r: JM.CGConv(IN, OUT, jax.nn.softplus, edge_features=EIN,
                            rngs=r),
        lambda: TM.CGConv(IN, OUT, softplus_t, edge_features=EIN, **KW),
        IN, EIN, "n"),
    "cgconv_residual": (lambda r: JM.CGConv(IN, IN, residual=True, rngs=r),
                        lambda: TM.CGConv(IN, IN, residual=True, **KW), IN,
                        0, "n"),
    "gmm": (lambda r: JM.GMMConv(IN, OUT, edge_features=EIN, K=2, rngs=r),
            lambda: TM.GMMConv(IN, OUT, edge_features=EIN, K=2, **KW), IN,
            EIN, "n"),
    "gmm_reference_exact": (
        lambda r: JM.GMMConv(IN, OUT, edge_features=EIN, K=2,
                             reference_exact=True, rngs=r),
        lambda: TM.GMMConv(IN, OUT, edge_features=EIN, K=2,
                           reference_exact=True, **KW), IN, EIN, "n"),
    "gmm_residual_relu": (
        lambda r: JM.GMMConv(IN, IN, jax.nn.relu, edge_features=EIN, K=2,
                             residual=True, rngs=r),
        lambda: TM.GMMConv(IN, IN, torch.relu, edge_features=EIN, K=2,
                           residual=True, **KW), IN, EIN, "n"),
    "megnet": (lambda r: JM.MEGNetConv(IN, OUT, rngs=r),
               lambda: TM.MEGNetConv(IN, OUT, **KW), IN, IN, "ne"),
    "megnet_given_phi_sum": (
        lambda r: JM.MEGNetConv(phi_e=JM.MLP([3 * IN, 6, OUT], rngs=r),
                                phi_v=JM.MLP([IN + OUT, OUT], rngs=r),
                                aggr="sum"),
        lambda: TM.MEGNetConv(phi_e=TM.MLP([3 * IN, 6, OUT], **KW),
                              phi_v=TM.MLP([IN + OUT, OUT], **KW),
                              aggr="sum"), IN, IN, "ne"),
    "egnn": (lambda r: JM.EGNNConv(IN, OUT, rngs=r),
             lambda: TM.EGNNConv(IN, OUT, **KW), IN, 0, "nn"),
    "egnn_e": (lambda r: JM.EGNNConv(IN, OUT, edge_features=EIN, rngs=r),
               lambda: TM.EGNNConv(IN, OUT, edge_features=EIN, **KW), IN,
               EIN, "nn"),
    "egnn_residual": (
        lambda r: JM.EGNNConv(IN, IN, hidden_size=6, residual=True, rngs=r),
        lambda: TM.EGNNConv(IN, IN, hidden_size=6, residual=True, **KW), IN,
        0, "nn"),
}


# one padding for every graph, so that a case's JAX gradient compiles once
# (jit caches by shape) for its three graphs
PADS = dict(n_pad=56, e_pad=256)


def _graphs(which, test_graphs, self_loops=True):
    """The JAX and port graphs: the directed multigraph (without its
    self-loops unless ``self_loops``), or a fixture graph's edges by
    index."""
    if which == "directed":
        s, r, n, _ = directed_graph_arrays(seed=7)
        keep = slice(None) if self_loops else s != r
        s, r = s[keep], r[keep]
    else:
        jg = test_graphs[which]
        ne, n = int(jg.num_edges), int(jg.num_nodes)
        s, r = np.asarray(jg.senders)[:ne], np.asarray(jg.receivers)[:ne]
    return (jgnn.graph(s, r, num_nodes=n, **PADS),
            tgnn.graph(s, r, num_nodes=n, device="cpu"))


def _call(layer, g, x, e=None, pos=None):
    """The layer's outputs as a tuple; EGNN takes ``(g, h, pos, e)``."""
    out = layer(g, x, pos, e) if pos is not None else layer(g, x, e)
    return out if isinstance(out, tuple) else (out,)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_value_and_grads(gd, keys, params, rest, jg, arrs, cots):
    """The outputs of ``nnx.merge(gd, params, rest)`` on ``jg`` and the
    inputs ``arrs`` (named ``keys``), and the gradients of ``sum(y * cot)``
    over its outputs by the parameters and each input."""
    def loss(p, *a):
        ys = _call(nnx.merge(gd, p, rest), jg, **dict(zip(keys, a)))
        return sum(jnp.sum(y * c) for y, c in zip(ys, cots)), ys

    return jax.value_and_grad(loss, argnums=tuple(range(len(keys) + 1)),
                              has_aux=True)(params, *arrs)


@pytest.mark.parametrize("which", ["directed", 0, 1],
                         ids=["directed", "fixture", "fixture_isolated"])
@pytest.mark.parametrize("name", list(CASES))
def test_edge_layer_matches_jax(test_graphs, name, which):
    make_j, make_t, din, ein, outs = CASES[name]
    # EGNN's sqrt(|pos_i - pos_j|^2) has no gradient at 0 in either package
    jg, tg = _graphs(which, test_graphs, not name.startswith("egnn"))
    n, ne = tg.num_nodes, tg.num_edges
    rng = np.random.default_rng(31)
    ins = {"x": rng.standard_normal((n, din))}
    if ein:
        ins["e"] = rng.standard_normal((ne, ein))
    if name.startswith("egnn"):
        ins["pos"] = rng.standard_normal((n, 3))
    keys = tuple(ins)

    jm = jax_params_f64(make_j(nnx.Rngs(0)))
    tm = port_from_jax(make_t(), jm)
    tin = {k: t(v, grad=True) for k, v in ins.items()}
    tys = _call(tm, tg, **tin)
    cots = [rng.standard_normal(y.shape) for y in tys]
    sum((y * t(c)).sum() for y, c in zip(tys, cots)).backward()

    def pad(a, kind):
        return jnp.asarray(pad_rows(a, jg.e_pad if kind == "e"
                                    else jg.n_pad))

    gd, params, rest = nnx.split(jm, nnx.Param, ...)
    (_, jys), grads = _jax_value_and_grads(
        gd, keys, params, rest, jg,
        [pad(ins[k], "e" if k == "e" else "n") for k in keys],
        [pad(c, o) for c, o in zip(cots, outs)])
    assert len(tys) == len(jys) == len(outs)
    for i, (ty, jy) in enumerate(zip(tys, jys)):
        np.testing.assert_allclose(ty.detach().numpy(),
                                   np.asarray(jy)[:ty.shape[0]],
                                   err_msg=f"output {i}", **F64_TOL)
    for k, gk in zip(keys, grads[1:]):
        np.testing.assert_allclose(tin[k].grad.numpy(),
                                   np.asarray(gk)[:len(ins[k])],
                                   err_msg=f"d{k}", **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray,
                                        nnx.to_pure_dict(grads[0])),
                       **F64_TOL)


@pytest.mark.parametrize("ein", [0, EIN])
def test_cgconv_bipartite_matches_jax(ein):
    """``(x_src, x_dst)`` input: 40 source and 30 target nodes, with and
    without edge features; the forward and every gradient."""
    rng = np.random.default_rng(12)
    s, r = rng.integers(0, 40, 150), rng.integers(0, 30, 150)
    jg, tg = graph_pair(s, r, 40)
    xs, xd = rng.standard_normal((40, IN)), rng.standard_normal((30, IN))
    e = rng.standard_normal((150, ein)) if ein else None
    cot = rng.standard_normal((30, OUT))
    jm = jax_params_f64(JM.CGConv(IN, OUT, jax.nn.softplus,
                                  edge_features=ein, rngs=nnx.Rngs(4)))
    tm = port_from_jax(TM.CGConv(IN, OUT, softplus_t, edge_features=ein,
                                 **KW), jm)
    gd, params, rest = nnx.split(jm, nnx.Param, ...)
    je = None if e is None else jnp.asarray(pad_rows(e, jg.e_pad))

    def jloss(p, a, b):
        y = nnx.merge(gd, p, rest)(jg, (a, b), je)
        return jnp.sum(y * cot), y

    (_, jy), (gp, gxs, gxd) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(pad_rows(xs, jg.n_pad)), jnp.asarray(xd))
    txs, txd = t(xs, grad=True), t(xd, grad=True)
    ty = tm(tg, (txs, txd), None if e is None else t(e))
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(txs.grad.numpy(), np.asarray(gxs)[:40],
                               **F64_TOL)
    np.testing.assert_allclose(txd.grad.numpy(), np.asarray(gxd), **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)


def test_egnn_reads_h_and_positions_from_the_graph():
    """With no arguments EGNNConv takes ``g.nodes["h"]`` and ``g.x``, as
    JAX's does."""
    s, r, n, _ = directed_graph_arrays(seed=8)
    keep = s != r
    rng = np.random.default_rng(13)
    h, pos = rng.standard_normal((n, IN)), rng.standard_normal((n, 3))
    jg = jgnn.graph(s[keep], r[keep], num_nodes=n,
                    nodes={"h": h, "x": pos})
    tg = tgnn.graph(s[keep], r[keep], num_nodes=n,
                    nodes={"h": h, "x": pos}, device="cpu")
    jm = jax_params_f64(JM.EGNNConv(IN, OUT, rngs=nnx.Rngs(6)))
    tm = port_from_jax(TM.EGNNConv(IN, OUT, **KW), jm)
    for a, b in zip(tm(tg), nnx.jit(lambda m: m(jg))(jm)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b)[:n],
                                   **F64_TOL)


def test_egnn_residual_needs_equal_widths():
    with pytest.raises(ValueError, match="in == out"):
        JM.EGNNConv(IN, OUT, residual=True, rngs=nnx.Rngs(0))
    with pytest.raises(ValueError, match="in == out"):
        TM.EGNNConv(IN, OUT, residual=True, **KW)
