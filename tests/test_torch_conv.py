"""Port's layers vs graphneuralnetworks_tpu/models/conv.py.

Each layer is built in both packages, the JAX weights (cast to float64) are
copied into the port with ``load_jax_params``, and the forward output and
the gradients of every parameter, of the input and, where given, of the
edge weights are compared (float64, XLA path: rtol 1e-9, atol 1e-10).
GATConv, GATv2Conv, AGNNConv and TransformerConv also run through their
kernel route (the autograd functions the card uses, on CPU tensors); the
GAT layers' attention dropout is checked on its own and, for GATv2Conv,
against JAX with numpy-made masks shared by both packages.
TransformerConv's batch norms (``nnx.BatchNorm``) are checked in training
mode and then in eval mode after the running statistics moved, and
``DotDecoder`` edge by edge. The layers with a max or min aggregation
(GraphConv, SAGEConv, GINConv, EdgeConv) also run through K14's route
(``SegmentMaxFunction``, the autograd function the card uses), and
EdgeConv on the reference's two 4-node test graphs too. The propagation
family (ResGatedGraph, SG, TAG, DConv over ``g.reverse()`` in both modes,
GatedGraph with its GRU cell, ChebConv with ``lambda_max`` given) is held to
JAX the same way; ChebConv's power-iteration paths are in
``tests/test_torch_cheb.py``.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as TS  # noqa: E402
from torch_parity import (F64_TOL, assert_grads_match,  # noqa: E402
                          directed_graph_arrays, graph_pair, jax_params_f64,
                          pad_rows, port_from_jax, t)

KW = dict(device="cpu", dtype=torch.float64)
relu_j, relu_t = jax.nn.relu, torch.relu
CHEB_LAMBDA = 1.7


class _JaxChebLam(JM.ChebConv):
    """ChebConv called with a fixed ``lambda_max`` (the zoo's
    ``ChebConv_lam2`` pattern, benchmarks/zoo_sweep_r5.py:46-52)."""

    def __call__(self, g, x=None):
        return super().__call__(g, x, lambda_max=CHEB_LAMBDA)


class _TorchChebLam(TM.ChebConv):
    def forward(self, g, x=None):
        return super().forward(g, x, lambda_max=CHEB_LAMBDA)

# name: (JAX layer, port layer, input width, passes explicit edge weights)
CASES = {
    "gcn": (lambda r: JM.GCNConv(3, 5, relu_j, rngs=r),
            lambda: TM.GCNConv(3, 5, relu_t, **KW), 3, False),
    "gcn_dout_lt_din": (lambda r: JM.GCNConv(6, 2, rngs=r),
                        lambda: TM.GCNConv(6, 2, **KW), 6, False),
    "gcn_use_edge_weight": (
        lambda r: JM.GCNConv(3, 5, relu_j, use_edge_weight=True, rngs=r),
        lambda: TM.GCNConv(3, 5, relu_t, use_edge_weight=True, **KW), 3,
        False),
    "gcn_explicit_edge_weight": (lambda r: JM.GCNConv(4, 4, rngs=r),
                                 lambda: TM.GCNConv(4, 4, **KW), 4, True),
    "gcn_explicit_edge_weight_dout_lt_din": (
        lambda r: JM.GCNConv(5, 2, rngs=r),
        lambda: TM.GCNConv(5, 2, **KW), 5, True),
    "gcn_no_self_loops": (
        lambda r: JM.GCNConv(3, 5, add_self_loops=False, rngs=r),
        lambda: TM.GCNConv(3, 5, add_self_loops=False, **KW), 3, False),
    "graphconv": (lambda r: JM.GraphConv(4, 5, relu_j, rngs=r),
                  lambda: TM.GraphConv(4, 5, relu_t, **KW), 4, False),
    "graphconv_max": (lambda r: JM.GraphConv(4, 3, aggr="max", rngs=r),
                      lambda: TM.GraphConv(4, 3, aggr="max", **KW), 4,
                      False),
    "gin": (lambda r: JM.GINConv(JM.MLP([4, 8, 3], relu_j, rngs=r), 0.1),
            lambda: TM.GINConv(TM.MLP([4, 8, 3], relu_t, **KW), 0.1), 4,
            False),
    "gin_max": (lambda r: JM.GINConv(JM.MLP([4, 3], relu_j, rngs=r), 0.1,
                                     aggr="max"),
                lambda: TM.GINConv(TM.MLP([4, 3], relu_t, **KW), 0.1,
                                   aggr="max"), 4, False),
    "sage_max": (lambda r: JM.SAGEConv(4, 3, relu_j, aggr="max", rngs=r),
                 lambda: TM.SAGEConv(4, 3, relu_t, aggr="max", **KW), 4,
                 False),
    "edgeconv": (lambda r: JM.EdgeConv(JM.MLP([8, 6, 3], relu_j, rngs=r)),
                 lambda: TM.EdgeConv(TM.MLP([8, 6, 3], relu_t, **KW)), 4,
                 False),
    "edgeconv_min": (lambda r: JM.EdgeConv(JM.MLP([6, 3], rngs=r),
                                           aggr="min"),
                     lambda: TM.EdgeConv(TM.MLP([6, 3], **KW), aggr="min"),
                     3, False),
    "edgeconv_mean": (lambda r: JM.EdgeConv(JM.MLP([6, 3], rngs=r),
                                            aggr="mean"),
                      lambda: TM.EdgeConv(TM.MLP([6, 3], **KW),
                                          aggr="mean"), 3, False),
    "sage": (lambda r: JM.SAGEConv(4, 5, relu_j, rngs=r),
             lambda: TM.SAGEConv(4, 5, relu_t, **KW), 4, False),
    "sage_sum": (lambda r: JM.SAGEConv(4, 3, aggr="sum", rngs=r),
                 lambda: TM.SAGEConv(4, 3, aggr="sum", **KW), 4, False),
    "gat": (lambda r: JM.GATConv(4, 3, relu_j, heads=2, rngs=r),
            lambda: TM.GATConv(4, 3, relu_t, heads=2, **KW), 4, False),
    "gat_mean_heads": (
        lambda r: JM.GATConv(4, 3, heads=3, concat=False, rngs=r),
        lambda: TM.GATConv(4, 3, heads=3, concat=False, **KW), 4, False),
    "gat_no_self_loops": (
        lambda r: JM.GATConv(5, 2, heads=2, add_self_loops=False, rngs=r),
        lambda: TM.GATConv(5, 2, heads=2, add_self_loops=False, **KW), 5,
        False),
    "gat_no_self_loops_mean_heads": (
        lambda r: JM.GATConv(4, 4, relu_j, concat=False,
                             add_self_loops=False, rngs=r),
        lambda: TM.GATConv(4, 4, relu_t, concat=False, add_self_loops=False,
                           **KW), 4, False),
    "gatv2": (lambda r: JM.GATv2Conv(4, 3, relu_j, heads=2, rngs=r),
              lambda: TM.GATv2Conv(4, 3, relu_t, heads=2, **KW), 4, False),
    "gatv2_one_head": (lambda r: JM.GATv2Conv(4, 5, rngs=r),
                       lambda: TM.GATv2Conv(4, 5, **KW), 4, False),
    "gatv2_mean_heads": (
        lambda r: JM.GATv2Conv(4, 3, heads=3, concat=False, rngs=r),
        lambda: TM.GATv2Conv(4, 3, heads=3, concat=False, **KW), 4, False),
    "gatv2_no_self_loops": (
        lambda r: JM.GATv2Conv(5, 2, heads=2, add_self_loops=False, rngs=r),
        lambda: TM.GATv2Conv(5, 2, heads=2, add_self_loops=False, **KW), 5,
        False),
    "gatv2_no_bias_mean_heads": (
        lambda r: JM.GATv2Conv(4, 4, relu_j, heads=2, concat=False,
                               use_bias=False, rngs=r),
        lambda: TM.GATv2Conv(4, 4, relu_t, heads=2, concat=False,
                             use_bias=False, **KW), 4, False),
    "agnn": (lambda r: JM.AGNNConv(init_beta=0.7, rngs=r),
             lambda: TM.AGNNConv(init_beta=0.7, **KW), 4, False),
    "agnn_no_self_loops": (
        lambda r: JM.AGNNConv(add_self_loops=False, rngs=r),
        lambda: TM.AGNNConv(add_self_loops=False, **KW), 3, False),
    # beta stays a float32 array in JAX: 0.75 is exact in both widths
    "agnn_fixed_beta": (
        lambda r: JM.AGNNConv(init_beta=0.75, trainable=False, rngs=r),
        lambda: TM.AGNNConv(init_beta=0.75, trainable=False, **KW), 4,
        False),
    # the option sets of tests/test_conv_layers.py:280-295, then self-loops,
    # skip connections and batch norms (running statistics: eval mode)
    "transformer": (lambda r: JM.TransformerConv(4, 3, rngs=r),
                    lambda: TM.TransformerConv(4, 3, **KW), 4, False),
    "transformer_gating": (
        lambda r: JM.TransformerConv(4, 3, gating=True, bias_qkv=False,
                                     rngs=r),
        lambda: TM.TransformerConv(4, 3, gating=True, bias_qkv=False, **KW),
        4, False),
    "transformer_ff_no_root": (
        lambda r: JM.TransformerConv(4, 3, root_weight=False, ff_channels=8,
                                     rngs=r),
        lambda: TM.TransformerConv(4, 3, root_weight=False, ff_channels=8,
                                   **KW), 4, False),
    "transformer_mean_heads": (
        lambda r: JM.TransformerConv(4, 3, heads=2, concat=False, rngs=r),
        lambda: TM.TransformerConv(4, 3, heads=2, concat=False, **KW), 4,
        False),
    "transformer_self_loops": (
        lambda r: JM.TransformerConv(4, 3, heads=2, add_self_loops=True,
                                     rngs=r),
        lambda: TM.TransformerConv(4, 3, heads=2, add_self_loops=True, **KW),
        4, False),
    "resgated": (lambda r: JM.ResGatedGraphConv(4, 3, relu_j, rngs=r),
                 lambda: TM.ResGatedGraphConv(4, 3, relu_t, **KW), 4, False),
    "resgated_no_bias": (
        lambda r: JM.ResGatedGraphConv(3, 5, use_bias=False, rngs=r),
        lambda: TM.ResGatedGraphConv(3, 5, use_bias=False, **KW), 3, False),
    # SGConv: W before the hops when out < in, after them otherwise
    "sgconv_k1": (lambda r: JM.SGConv(3, 5, rngs=r),
                  lambda: TM.SGConv(3, 5, **KW), 3, False),
    "sgconv_k2_dout_lt_din": (lambda r: JM.SGConv(6, 2, 2, rngs=r),
                              lambda: TM.SGConv(6, 2, 2, **KW), 6, False),
    "sgconv_k2_no_self_loops": (
        lambda r: JM.SGConv(4, 4, 2, add_self_loops=False, rngs=r),
        lambda: TM.SGConv(4, 4, 2, add_self_loops=False, **KW), 4, False),
    "sgconv_k2_use_edge_weight": (
        lambda r: JM.SGConv(3, 5, 2, use_edge_weight=True, rngs=r),
        lambda: TM.SGConv(3, 5, 2, use_edge_weight=True, **KW), 3, False),
    "sgconv_k2_explicit_edge_weight_dout_lt_din": (
        lambda r: JM.SGConv(5, 2, 2, rngs=r),
        lambda: TM.SGConv(5, 2, 2, **KW), 5, True),
    "tagconv": (lambda r: JM.TAGConv(4, 3, 3, rngs=r),
                lambda: TM.TAGConv(4, 3, 3, **KW), 4, False),
    "tagconv_use_edge_weight_no_self_loops": (
        lambda r: JM.TAGConv(3, 4, 2, add_self_loops=False,
                             use_edge_weight=True, rngs=r),
        lambda: TM.TAGConv(3, 4, 2, add_self_loops=False,
                           use_edge_weight=True, **KW), 3, False),
    "tagconv_explicit_edge_weight": (
        lambda r: JM.TAGConv(4, 2, 3, use_bias=False, rngs=r),
        lambda: TM.TAGConv(4, 2, 3, use_bias=False, **KW), 4, True),
    # DConv runs over g and g.reverse(), the graph's weights on both
    "dconv": (lambda r: JM.DConv(4, 3, 3, rngs=r),
              lambda: TM.DConv(4, 3, 3, **KW), 4, False),
    "dconv_k1": (lambda r: JM.DConv(3, 2, 1, rngs=r),
                 lambda: TM.DConv(3, 2, 1, **KW), 3, False),
    "dconv_reference_exact": (
        lambda r: JM.DConv(4, 3, 3, reference_exact=True, rngs=r),
        lambda: TM.DConv(4, 3, 3, reference_exact=True, **KW), 4, False),
    # the input zero-padded to out_features (3 -> 5)
    "gatedgraph": (lambda r: JM.GatedGraphConv(5, 2, rngs=r),
                   lambda: TM.GatedGraphConv(5, 2, **KW), 3, False),
    "gatedgraph_mean": (lambda r: JM.GatedGraphConv(4, 3, aggr="mean",
                                                    rngs=r),
                        lambda: TM.GatedGraphConv(4, 3, aggr="mean", **KW),
                        4, False),
    "gatedgraph_max": (lambda r: JM.GatedGraphConv(4, 2, aggr="max", rngs=r),
                       lambda: TM.GatedGraphConv(4, 2, aggr="max", **KW), 2,
                       False),
    # lambda_max given: the matrix-free path at any size, no power iteration
    "cheb_lambda_given": (lambda r: _JaxChebLam(4, 3, 3, rngs=r),
                          lambda: _TorchChebLam(4, 3, 3, **KW), 4, False),
    "transformer_skip_gating_ff_bn": (
        lambda r: JM.TransformerConv(6, 3, heads=2, skip_connection=True,
                                     gating=True, ff_channels=5,
                                     batch_norm=True, rngs=r),
        lambda: TM.TransformerConv(6, 3, heads=2, skip_connection=True,
                                   gating=True, ff_channels=5,
                                   batch_norm=True, **KW), 6, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_jax(name):
    make_j, make_t, din, explicit_w = CASES[name]
    s, r, n, w = directed_graph_arrays(seed=7)
    jg, tg = graph_pair(s, r, n, w)
    ne = len(s)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, din))
    ew = rng.random(ne) + 0.5

    jm = jax_params_f64(make_j(nnx.Rngs(0)))
    tm = port_from_jax(make_t(), jm)
    out_w = jm(jg, jnp.asarray(pad_rows(x, jg.n_pad))).shape[1]
    cot = rng.standard_normal((n, out_w))

    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, xp, wp):
        kw = {"edge_weight": wp} if explicit_w else {}
        y = nnx.merge(gd, p, rest)(jg, xp, **kw)[:n]
        return jnp.sum(y * cot), y

    (_, jy), (gp, gx, gw) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(pad_rows(x, jg.n_pad)),
        jnp.asarray(pad_rows(ew, jg.e_pad)))

    tx, tw = t(x, grad=True), t(ew, grad=True)
    ty = tm(tg, tx, **({"edge_weight": tw} if explicit_w else {}))
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx)[:n],
                               **F64_TOL)
    if explicit_w:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw)[:ne],
                                   **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)


@pytest.mark.parametrize("name", ["graphconv_max", "gin_max", "sage_max",
                                  "edgeconv", "edgeconv_min",
                                  "gatedgraph_max"])
def test_max_aggregation_kernel_route_matches_jax(monkeypatch, name):
    """The max and min cases of :data:`CASES` once more, by K14's route."""
    monkeypatch.setattr(TS, "_kernel_route", lambda t: True)
    test_layer_matches_jax(name)


@pytest.mark.parametrize("route_kernels", [False, True])
@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_edgeconv_on_fixture_graphs_matches_jax(test_graphs, monkeypatch,
                                                route_kernels, aggr):
    """EdgeConv on the reference's 4-node test graphs (one with an isolated
    vertex: a row without in-edges), forward and every gradient."""
    if route_kernels:
        monkeypatch.setattr(TS, "_kernel_route", lambda t: True)
    rng = np.random.default_rng(24)
    for jg in test_graphs:
        n, ne = int(jg.num_nodes), int(jg.num_edges)
        tg = tgnn.graph(np.asarray(jg.senders)[:ne],
                        np.asarray(jg.receivers)[:ne], num_nodes=n,
                        device="cpu")
        jm = jax_params_f64(JM.EdgeConv(JM.MLP([6, 5, 2], relu_j,
                                               rngs=nnx.Rngs(3)), aggr=aggr))
        tm = port_from_jax(TM.EdgeConv(TM.MLP([6, 5, 2], relu_t, **KW),
                                       aggr=aggr), jm)
        x = rng.standard_normal((n, 3))
        cot = rng.standard_normal((n, 2))
        gd, params, rest = nnx.split(jm, nnx.Param, ...)

        def jloss(p, xp):
            y = nnx.merge(gd, p, rest)(jg, xp)[:n]
            return jnp.sum(y * cot), y

        (_, jy), (gp, gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(pad_rows(x, jg.n_pad)))
        tx = t(x, grad=True)
        ty = tm(tg, tx)
        (ty * t(cot)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   **F64_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx)[:n],
                                   **F64_TOL)
        assert_grads_match(tm, jax.tree.map(np.asarray,
                                            nnx.to_pure_dict(gp)), **F64_TOL)


def test_gatedgraph_rejects_a_wider_input():
    with pytest.raises(ValueError, match="out_features"):
        TM.GatedGraphConv(3, 1, **KW)(
            tgnn.graph([0, 1], [1, 0], device="cpu"),
            torch.zeros(2, 4, dtype=torch.float64))


def test_gru_cell_matches_flax():
    """The port's ``GRUCell`` against ``nnx.GRUCell`` called as
    ``GatedGraphConv`` calls it, ``cell(h, x)``, with every gradient."""
    rng = np.random.default_rng(41)
    h, x = rng.standard_normal((6, 4)), rng.standard_normal((6, 3))
    cot = rng.standard_normal((6, 4))
    jc = jax_params_f64(nnx.GRUCell(3, 4, rngs=nnx.Rngs(5)))
    tc = port_from_jax(TM.GRUCell(3, 4, **KW), jc)
    gd, params, rest = nnx.split(jc, nnx.Param, ...)

    def jloss(p, hp, xp):
        y, _ = nnx.merge(gd, p, rest)(hp, xp)
        return jnp.sum(y * cot), y

    (_, jy), (gp, gh, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(h),
                                                jnp.asarray(x))
    th, tx = t(h, grad=True), t(x, grad=True)
    ty = tc(th, tx)
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **F64_TOL)
    assert_grads_match(tc, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)
    assert tc.dense_h.bias is None and tc.dense_i.bias is not None


def test_gcn_norm_fn_and_conv_weight_overrides():
    s, r, n, w = directed_graph_arrays(seed=9)
    jg, tg = graph_pair(s, r, n, w)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 3))
    cw = rng.standard_normal((3, 4))
    jm = jax_params_f64(JM.GCNConv(3, 4, rngs=nnx.Rngs(1)))
    tm = port_from_jax(TM.GCNConv(3, 4, **KW), jm)
    jy = jm(jg, jnp.asarray(pad_rows(x, jg.n_pad)),
            norm_fn=lambda d: 1.0 / jnp.maximum(d, 1.0),
            conv_weight=jnp.asarray(cw))
    ty = tm(tg, t(x), norm_fn=lambda d: 1.0 / d.clamp(min=1.0),
            conv_weight=t(cw))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy)[:n],
                               **F64_TOL)


def test_load_jax_params_rejects_mismatches():
    jm = JM.GCNConv(3, 4, rngs=nnx.Rngs(0))
    tm = TM.GCNConv(3, 5, **KW)
    with pytest.raises(ValueError):
        port_from_jax(tm, jm)
    from graphneuralnetworks_tpu_torch.interop import load_jax_params
    with pytest.raises(KeyError):
        load_jax_params(tm, {"kernel": np.zeros((3, 5))})
    # GatedGraphConv's GRU cell: dense_h has no bias, a wrong width raises
    jg = JM.GatedGraphConv(4, 2, rngs=nnx.Rngs(0))
    with pytest.raises(ValueError):
        port_from_jax(TM.GatedGraphConv(5, 2, **KW), jg)
    with pytest.raises(KeyError):
        load_jax_params(TM.GatedGraphConv(4, 2, **KW),
                        {"gru": {"dense_h": {"bias": np.zeros(12)}}})
    with pytest.raises(ValueError):      # DConv's [2, k, in, out]
        port_from_jax(TM.DConv(3, 4, 3, **KW),
                      JM.DConv(3, 4, 2, rngs=nnx.Rngs(0)))


def test_layers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TM.GCNConv(3, 4), lambda: TM.MLP([3, 4]),
                 lambda: TM.SAGEConv(3, 4), lambda: TM.GraphConv(3, 4),
                 lambda: TM.GATConv(3, 4, heads=2), lambda: TM.AGNNConv(),
                 lambda: TM.TransformerConv(3, 4, heads=2),
                 lambda: TM.TopKPool(3, 2), lambda: TM.Set2Set(3, 2),
                 lambda: TM.ResGatedGraphConv(3, 4),
                 lambda: TM.GatedGraphConv(4, 2), lambda: TM.GRUCell(3, 4),
                 lambda: TM.ChebConv(3, 4, 2), lambda: TM.SGConv(3, 4),
                 lambda: TM.TAGConv(3, 4), lambda: TM.DConv(3, 4, 2),
                 lambda: TM.NNConv(3, 4, torch.nn.Linear(2, 12)),
                 lambda: TM.CGConv(3, 4), lambda: TM.MEGNetConv(3, 4),
                 lambda: TM.GMMConv(3, 4), lambda: TM.EGNNConv(3, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_has_every_layer_of_the_jax_conv_module():
    """Every name in the JAX package's ``models/conv.py`` ``__all__`` (read
    from its source, no JAX import) is in the port's."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "graphneuralnetworks_tpu", "models",
        "conv.py")
    tree = ast.parse(open(path).read(), filename=path)
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "__all__"
                         for t in node.targets))
    from graphneuralnetworks_tpu_torch.models import conv
    assert len(names) == 21
    assert not set(names) - set(conv.__all__)


def test_gcn_bipartite_matches_jax():
    """(x_src, x_dst) input: separate source/target degree norms, no
    self-loop; 40 source and 30 target nodes."""
    rng = np.random.default_rng(11)
    s, r = rng.integers(0, 40, 150), rng.integers(0, 30, 150)
    jg, tg = graph_pair(s, r, 40)
    xs, xd = rng.standard_normal((40, 3)), rng.standard_normal((30, 3))
    jm = jax_params_f64(JM.GCNConv(3, 4, relu_j, rngs=nnx.Rngs(2)))
    tm = port_from_jax(TM.GCNConv(3, 4, relu_t, **KW), jm)
    jy = jm(jg, (jnp.asarray(pad_rows(xs, jg.n_pad)), jnp.asarray(xd)))
    txs = t(xs, grad=True)
    ty = tm(tg, (txs, t(xd)))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **F64_TOL)
    ty.sum().backward()
    jgx = jax.grad(lambda a: jnp.sum(jm(jg, (a, jnp.asarray(xd)))))(
        jnp.asarray(pad_rows(xs, jg.n_pad)))
    np.testing.assert_allclose(txs.grad.numpy(), np.asarray(jgx)[:40],
                               **F64_TOL)


def test_chain_threads_kwargs_and_withgraph_trains_features():
    s, r, n, w = directed_graph_arrays(seed=12)
    _, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(12)
    x, ew = t(rng.standard_normal((n, 3))), t(rng.random(len(s)) + 0.5)
    conv = TM.GCNConv(3, 4, **KW)
    lin = torch.nn.Linear(4, 2, dtype=torch.float64)
    chain = TM.GNNChain(conv=conv, act=torch.tanh, head=lin)
    assert chain["conv"] is conv and len(chain[1:]) == 2
    # edge_weight reaches the conv (it accepts it), not tanh or the Linear
    want = lin(torch.tanh(conv(tg, x, edge_weight=ew)))
    got = chain(tg, x, edge_weight=ew)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **F64_TOL)
    wg = TM.WithGraph(chain, tg.with_nodes(x=x.clone()), traingraph=True)
    names = {k for k, _ in wg.named_parameters()}
    assert "_nfeat.x" in names
    wg().sum().backward()
    assert wg._nfeat["x"].grad is not None and conv.weight.grad is not None
    np.testing.assert_allclose(wg(tg, x).detach().numpy(),
                               chain(tg, x).detach().numpy(), **F64_TOL)


# ---- GATConv: edge features, bipartite input, kernel route, dropout --------

def _gat_case(jm, tm, jg, tg, jargs, targs, rng, n_out, **call_kw):
    """Forward and the gradients of every parameter and every float input
    of ``sum(y * cot)``; ``targs[i]`` are the first rows of ``jargs[i]``;
    ``call_kw`` go to both layers' calls."""
    cot = rng.standard_normal((n_out, tm.out_features * (
        tm.heads if tm.concat else 1)))
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, *xs):
        y = nnx.merge(gd, p, rest)(jg, *xs, **call_kw)[:n_out]
        return jnp.sum(y * cot), y

    def flat(xs):
        return [a for x in xs for a in (x if isinstance(x, tuple) else (x,))]

    (_, jy), grads = jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(jargs))), has_aux=True)(
        params, *jargs)
    ty = tm(tg, *targs, **call_kw)
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    for tx, gx in zip(flat(targs), flat(grads[1:])):
        np.testing.assert_allclose(tx.grad.numpy(),
                                   np.asarray(gx)[:tx.shape[0]], **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(
        grads[0])), **F64_TOL)


@pytest.fixture(params=["plain", "kernels"])
def gat_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    return request.param


@pytest.mark.parametrize("name", [k for k in CASES if k.startswith(
    ("gat", "agnn", "transformer"))])
def test_gat_kernel_route_matches_jax(monkeypatch, name):
    """The attention cases of :data:`CASES` once more, by the kernel
    route."""
    monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    test_layer_matches_jax(name)


def test_gat_edge_features_matches_jax(gat_route):
    s, r, n, _ = directed_graph_arrays(seed=13)
    jg, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, 4))
    e = rng.standard_normal((len(s), 2))            # stored edge order
    jm = jax_params_f64(JM.GATConv(4, 3, relu_j, heads=2, edge_features=2,
                                   add_self_loops=False, rngs=nnx.Rngs(3)))
    tm = port_from_jax(TM.GATConv(4, 3, relu_t, heads=2, edge_features=2,
                                  add_self_loops=False, **KW), jm)
    _gat_case(jm, tm, jg, tg,
              [jnp.asarray(pad_rows(x, jg.n_pad)),
               jnp.asarray(pad_rows(e, jg.e_pad))],
              [t(x, grad=True), t(e, grad=True)], rng, n)
    with pytest.raises(ValueError):
        tm(tg, t(x))
    with pytest.raises(ValueError):
        TM.GATConv(4, 3, edge_features=2, **KW)


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gat_bipartite_matches_jax(gat_route, add_self_loops):
    """(x_src, x_dst): 40 source and 30 target nodes."""
    rng = np.random.default_rng(14)
    s, r = rng.integers(0, 40, 150), rng.integers(0, 30, 150)
    jg, tg = graph_pair(s, r, 40)
    xs, xd = rng.standard_normal((40, 3)), rng.standard_normal((30, 3))
    jm = jax_params_f64(JM.GATConv(3, 2, heads=2,
                                   add_self_loops=add_self_loops,
                                   rngs=nnx.Rngs(4)))
    tm = port_from_jax(TM.GATConv(3, 2, heads=2,
                                  add_self_loops=add_self_loops, **KW), jm)
    _gat_case(jm, tm, jg, tg,
              [(jnp.asarray(pad_rows(xs, jg.n_pad)), jnp.asarray(xd))],
              [(t(xs, grad=True), t(xd, grad=True))], rng, 30)


def test_gat_dropout_masks_share_and_scale():
    from graphneuralnetworks_tpu_torch.models.conv import _attn_dropout_masks
    gen = torch.Generator().manual_seed(0)
    me, ms = _attn_dropout_masks(0.6, gen, 20000, 500, 4, True, "cpu",
                                 torch.float64)
    assert me.shape == (20000, 4) and ms.shape == (500, 4)
    for m in (me, ms):
        vals = set(np.unique(m.numpy()).tolist())
        assert vals <= {0.0, 1 / 0.4}
    assert abs(float((me == 0).double().mean()) - 0.6) < 0.01
    _, none = _attn_dropout_masks(0.6, gen, 10, 5, 1, False, "cpu",
                                  torch.float64)
    assert none is None


@pytest.mark.parametrize("route_kernels", [False, True])
def test_gat_dropout_is_seeded_and_stochastic(monkeypatch, route_kernels):
    monkeypatch.setattr(TA, "_kernel_route", lambda t: route_kernels)
    s, r, n, _ = directed_graph_arrays(seed=15)
    _, tg = graph_pair(s, r, n)
    x = t(np.random.default_rng(15).standard_normal((n, 4)))

    def layer(seed, p=0.6):
        return TM.GATConv(4, 3, heads=2, dropout=p,
                          generator=torch.Generator().manual_seed(seed), **KW)

    a, b = layer(1), layer(1)
    ya, yb = a(tg, x, deterministic=False), b(tg, x, deterministic=False)
    np.testing.assert_array_equal(ya.detach().numpy(), yb.detach().numpy())
    y_det = a(tg, x)
    assert np.isfinite(ya.detach().numpy()).all()
    assert not np.allclose(ya.detach().numpy(), y_det.detach().numpy())
    # a second stochastic call draws new masks; deterministic=True is the
    # layer without dropout
    assert not np.allclose(a(tg, x, deterministic=False).detach().numpy(),
                           ya.detach().numpy())
    plain = layer(1, p=0.0)
    plain.load_state_dict(a.state_dict())
    np.testing.assert_allclose(plain(tg, x).detach().numpy(),
                               y_det.detach().numpy(), **F64_TOL)
    # GNNChain threads deterministic= to the layer
    chain = TM.GNNChain(layer(2), torch.nn.Linear(6, 2, dtype=torch.float64))
    y1 = chain(tg, x, deterministic=False)
    assert not np.allclose(y1.detach().numpy(), chain(tg, x).detach().numpy())


# ---- GATv2Conv: edge features, bipartite input, dropout --------------------

def test_gatv2_edge_features_matches_jax(gat_route):
    s, r, n, _ = directed_graph_arrays(seed=17)
    jg, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((n, 4))
    e = rng.standard_normal((len(s), 2))            # stored edge order
    jm = jax_params_f64(JM.GATv2Conv(4, 3, relu_j, heads=2, edge_features=2,
                                     add_self_loops=False, rngs=nnx.Rngs(5)))
    tm = port_from_jax(TM.GATv2Conv(4, 3, relu_t, heads=2, edge_features=2,
                                    add_self_loops=False, **KW), jm)
    _gat_case(jm, tm, jg, tg,
              [jnp.asarray(pad_rows(x, jg.n_pad)),
               jnp.asarray(pad_rows(e, jg.e_pad))],
              [t(x, grad=True), t(e, grad=True)], rng, n)
    with pytest.raises(ValueError):
        tm(tg, t(x))
    with pytest.raises(ValueError):
        TM.GATv2Conv(4, 3, edge_features=2, **KW)


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gatv2_bipartite_matches_jax(gat_route, add_self_loops):
    """(x_src, x_dst): 40 source and 30 target nodes."""
    rng = np.random.default_rng(18)
    s, r = rng.integers(0, 40, 150), rng.integers(0, 30, 150)
    jg, tg = graph_pair(s, r, 40)
    xs, xd = rng.standard_normal((40, 3)), rng.standard_normal((30, 3))
    jm = jax_params_f64(JM.GATv2Conv(3, 2, heads=2,
                                     add_self_loops=add_self_loops,
                                     rngs=nnx.Rngs(6)))
    tm = port_from_jax(TM.GATv2Conv(3, 2, heads=2,
                                    add_self_loops=add_self_loops, **KW), jm)
    _gat_case(jm, tm, jg, tg,
              [(jnp.asarray(pad_rows(xs, jg.n_pad)), jnp.asarray(xd))],
              [(t(xs, grad=True), t(xd, grad=True))], rng, 30)


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gatv2_dropout_shared_masks_match_jax(gat_route, monkeypatch,
                                              add_self_loops):
    """deterministic=False with the same numpy-made masks in both packages
    (each package's mask draw is replaced): forward and every gradient."""
    from graphneuralnetworks_tpu.models import conv as jconv
    from graphneuralnetworks_tpu_torch.models import conv as tconv

    s, r, n, _ = directed_graph_arrays(seed=19)
    jg, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(19)
    x = rng.standard_normal((n, 4))
    me = (rng.random((jg.e_pad, 2)) < 0.4) / 0.4
    ms = (rng.random((jg.n_pad, 2)) < 0.4) / 0.4
    monkeypatch.setattr(
        jconv, "_attn_dropout_masks",
        lambda module, g, n_dst, h, det, with_self: None if det else (
            jnp.asarray(me), jnp.asarray(ms) if with_self else None))
    monkeypatch.setattr(
        tconv, "_attn_dropout_masks",
        lambda p, gen, n_edges, n_dst, h, with_self, device, dtype: (
            t(me[:n_edges]), t(ms[:n_dst]) if with_self else None))
    jm = jax_params_f64(JM.GATv2Conv(4, 3, heads=2, dropout=0.6,
                                     add_self_loops=add_self_loops,
                                     rngs=nnx.Rngs(7)))
    tm = port_from_jax(TM.GATv2Conv(4, 3, heads=2, dropout=0.6,
                                    add_self_loops=add_self_loops, **KW), jm)
    _gat_case(jm, tm, jg, tg, [jnp.asarray(pad_rows(x, jg.n_pad))],
              [t(x, grad=True)], rng, n, deterministic=False)


def test_gatv2_dropout_is_seeded_and_stochastic(gat_route):
    s, r, n, _ = directed_graph_arrays(seed=20)
    _, tg = graph_pair(s, r, n)
    x = t(np.random.default_rng(20).standard_normal((n, 4)))

    def layer(seed, p=0.6):
        return TM.GATv2Conv(4, 3, heads=2, dropout=p,
                            generator=torch.Generator().manual_seed(seed),
                            **KW)

    a, b = layer(1), layer(1)
    ya, yb = a(tg, x, deterministic=False), b(tg, x, deterministic=False)
    np.testing.assert_array_equal(ya.detach().numpy(), yb.detach().numpy())
    y_det = a(tg, x)
    assert np.isfinite(ya.detach().numpy()).all()
    assert not np.allclose(ya.detach().numpy(), y_det.detach().numpy())
    assert not np.allclose(a(tg, x, deterministic=False).detach().numpy(),
                           ya.detach().numpy())
    plain = layer(1, p=0.0)
    plain.load_state_dict(a.state_dict())
    np.testing.assert_allclose(plain(tg, x).detach().numpy(),
                               y_det.detach().numpy(), **F64_TOL)


# ---- TransformerConv: edge features, batch norms; DotDecoder ---------------

def test_transformer_edge_features_matches_jax(gat_route):
    """Edge features shift keys and values per edge: gathered logits, then
    the softmax of edge values (K12 on the card)."""
    s, r, n, _ = directed_graph_arrays(seed=21)
    jg, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, 4))
    e = rng.standard_normal((len(s), 2))            # stored edge order
    jm = jax_params_f64(JM.TransformerConv(4, 3, heads=2, edge_features=2,
                                           gating=True, rngs=nnx.Rngs(8)))
    tm = port_from_jax(TM.TransformerConv(4, 3, heads=2, edge_features=2,
                                          gating=True, **KW), jm)
    _gat_case(jm, tm, jg, tg,
              [jnp.asarray(pad_rows(x, jg.n_pad)),
               jnp.asarray(pad_rows(e, jg.e_pad))],
              [t(x, grad=True), t(e, grad=True)], rng, n)
    with pytest.raises(ValueError, match="not configured"):
        TM.TransformerConv(4, 3, **KW)(tg, t(x), t(e))
    with pytest.raises(ValueError, match="add_self_loops"):
        TM.TransformerConv(4, 3, edge_features=2, add_self_loops=True, **KW)


def test_transformer_batch_norm_train_then_eval_matches_jax(gat_route):
    """``batch_norm=True, ff_channels=5``: one training-mode call
    (``deterministic=False``: batch statistics, running statistics updated
    with nnx's momentum 0.99 and biased variance), forward and every
    gradient; then an eval-mode call on the moved running statistics. The
    JAX graph is built without padding rows, which its batch norm would
    count."""
    from graphneuralnetworks_tpu_torch.interop import load_jax_params
    s, r, n, _ = directed_graph_arrays(seed=22)
    import graphneuralnetworks_tpu as jgnn
    jg = jgnn.graph(s, r, num_nodes=n, n_pad=n, e_pad=len(s))
    _, tg = graph_pair(s, r, n)
    rng = np.random.default_rng(22)
    x, x2 = rng.standard_normal((n, 4)), rng.standard_normal((n, 4))
    jm = jax_params_f64(JM.TransformerConv(4, 3, heads=2, batch_norm=True,
                                           ff_channels=5, rngs=nnx.Rngs(9)))
    nnx.update(jm, jax.tree.map(lambda a: a.astype(jnp.float64),
                                nnx.state(jm, nnx.BatchStat)))
    tm = port_from_jax(TM.TransformerConv(4, 3, heads=2, batch_norm=True,
                                          ff_channels=5, **KW), jm)
    cot = rng.standard_normal((n, 6))

    def jloss(m, xp):
        y = m(jg, xp, deterministic=False)
        return jnp.sum(y * cot), y

    # nnx's transform also moves jm's running statistics, once
    (_, jy), (gp, gx) = nnx.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(jm, jnp.asarray(x))
    tx = t(x, grad=True)
    ty = tm(tg, tx, deterministic=False)            # moves the port's stats
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)
    stats = jax.tree.map(np.asarray, nnx.to_pure_dict(
        nnx.state(jm, nnx.BatchStat)))
    np.testing.assert_allclose(tm.BN1.running_var.numpy(),
                               stats["BN1"]["var"], **F64_TOL)
    np.testing.assert_allclose(tm.BN2.running_mean.numpy(),
                               stats["BN2"]["mean"], **F64_TOL)
    assert not np.allclose(stats["BN1"]["var"], 1.0)
    jy = jm(jg, jnp.asarray(x2))
    np.testing.assert_allclose(tm(tg, t(x2)).detach().numpy(),
                               np.asarray(jy), **F64_TOL)
    # the statistics also carry across on their own
    fresh = port_from_jax(TM.TransformerConv(4, 3, heads=2, batch_norm=True,
                                             ff_channels=5, **KW), jm)
    load_jax_params(fresh, stats)
    np.testing.assert_allclose(fresh(tg, t(x2)).detach().numpy(),
                               np.asarray(jy), **F64_TOL)


def test_dot_decoder_matches_jax(gat_route, monkeypatch):
    """``apply_edges(xi_dot_xj, g, x, x)`` -> ``[E, 1]`` and the gradient of
    ``x``, through the SDDMM route (K13, K1 twice) on ``kernels``."""
    from graphneuralnetworks_tpu_torch.ops import msgpass as TMP
    if gat_route == "kernels":
        monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    s, r, n, _ = directed_graph_arrays(seed=23)
    jg, tg = graph_pair(s, r, n)
    ne = len(s)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((n, 5))
    cot = rng.standard_normal((ne, 1))

    def jloss(xp):
        y = JM.DotDecoder()(jg, xp)[:ne]
        return jnp.sum(y * cot), y

    (_, jy), jgx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pad_rows(x, jg.n_pad)))
    tx = t(x, grad=True)
    ty = TM.DotDecoder()(tg, tx)
    assert ty.shape == (ne, 1)
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx)[:n],
                               **F64_TOL)
