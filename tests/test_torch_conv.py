"""Port's main-path layers vs graphneuralnetworks_tpu/models/conv.py.

Each layer is built in both packages, the JAX weights (cast to float64) are
copied into the port with ``load_jax_params``, and the forward output and
the gradients of every parameter, of the input and, where given, of the
edge weights are compared (float64, XLA path: rtol 1e-9, atol 1e-10).
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
from torch_parity import (F64_TOL, assert_grads_match,  # noqa: E402
                          directed_graph_arrays, graph_pair, jax_params_f64,
                          pad_rows, port_from_jax, t)

KW = dict(device="cpu", dtype=torch.float64)
relu_j, relu_t = jax.nn.relu, torch.relu

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
    "sage": (lambda r: JM.SAGEConv(4, 5, relu_j, rngs=r),
             lambda: TM.SAGEConv(4, 5, relu_t, **KW), 4, False),
    "sage_sum": (lambda r: JM.SAGEConv(4, 3, aggr="sum", rngs=r),
                 lambda: TM.SAGEConv(4, 3, aggr="sum", **KW), 4, False),
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


def test_layers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TM.GCNConv(3, 4), lambda: TM.MLP([3, 4]),
                 lambda: TM.SAGEConv(3, 4), lambda: TM.GraphConv(3, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


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
