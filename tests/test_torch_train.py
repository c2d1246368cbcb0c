"""The port's training path vs the JAX package, and the Cora bar on the CPU.

- Three Adam steps of a 2-layer GCN with a Dense head in both packages from
  the same weights (float64, XLA path): the loss at each step and the final
  parameters match (rtol 1e-9, atol 1e-10). ``optax.adam`` and
  ``torch.optim.Adam`` apply the same update.
- The Cora bar (tests/test_integration_cora.py): GCN, GraphConv, SAGE and
  GIN, 40 epochs of Adam, train accuracy > 0.94 and test accuracy > 0.69,
  on the same seeded Cora analogue, which both packages build identically.
"""

import copy

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu import training as JT  # noqa: E402
from graphneuralnetworks_tpu.data.datasets import \
    synthetic_cora as j_synthetic_cora  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import training as TT  # noqa: E402
from graphneuralnetworks_tpu_torch.data import load_cora, synthetic_cora  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from torch_parity import (F64_TOL, jax_params_f64, pad_rows,  # noqa: E402
                          port_from_jax, pure_params, t)

KW = dict(device="cpu", dtype=torch.float64)


def test_adam_steps_match_jax():
    n, din, nh, nout = 60, 12, 10, 4
    rng = np.random.default_rng(2)
    jg = jgnn.rand_graph(n, 300, seed=2)
    tg = tgnn.rand_graph(n, 300, seed=2, device="cpu")
    x = rng.standard_normal((n, din))
    y = rng.integers(0, nout, n)
    mask = rng.random(n) < 0.5

    r = nnx.Rngs(17)
    jm = jax_params_f64(JM.GNNChain(JM.GCNConv(din, nh, jax.nn.relu, rngs=r),
                                    JM.GCNConv(nh, nh, jax.nn.relu, rngs=r),
                                    nnx.Linear(nh, nout, rngs=r)))
    tm = port_from_jax(TM.GNNChain(
        TM.GCNConv(din, nh, torch.relu, **KW),
        TM.GCNConv(nh, nh, torch.relu, **KW),
        torch.nn.Linear(nh, nout, dtype=torch.float64)), jm)

    state = JT.TrainState(jm, optax.adam(1e-2))
    jstep = JT.make_train_step(state, lambda m, g, x, y, k:
                               JT.masked_cross_entropy(m(g, x), y, k))
    tstep = TT.make_train_step(tm, torch.optim.Adam(tm.parameters(), 1e-2),
                               lambda m, g, x, y, k:
                               TT.masked_cross_entropy(m(g, x), y, k))
    params, opt_state = state.params, state.opt_state
    jx = jnp.asarray(pad_rows(x, jg.n_pad))
    jy = jnp.asarray(pad_rows(y, jg.n_pad))
    jk = jnp.asarray(pad_rows(mask, jg.n_pad))
    for _ in range(3):
        params, opt_state, jloss = jstep(params, opt_state, jg, jx, jy, jk)
        tloss = tstep(tg, t(x), torch.tensor(y), torch.tensor(mask))
        np.testing.assert_allclose(float(tloss), float(jloss), **F64_TOL)

    want = load_jax_params(copy.deepcopy(tm), pure_params(state.model(params)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=name, **F64_TOL)


def test_synthetic_cora_matches_jax():
    jd = j_synthetic_cora(seed=1)
    td = synthetic_cora(seed=1, device="cpu")
    n, ne = int(jd.graph.num_nodes), int(jd.graph.num_edges)
    g = td.graph
    assert (g.num_nodes, g.num_edges) == (n, ne)
    np.testing.assert_array_equal(g.senders.numpy(),
                                  np.asarray(jd.graph.senders)[:ne])
    np.testing.assert_array_equal(g.receivers.numpy(),
                                  np.asarray(jd.graph.receivers)[:ne])
    np.testing.assert_array_equal(g.x.numpy(), np.asarray(jd.graph.x)[:n])
    np.testing.assert_array_equal(g.nodes["y"].numpy(),
                                  np.asarray(jd.graph.nodes["y"])[:n])
    for k in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      getattr(jd, k)[:n])


@pytest.mark.parametrize("fmt", ["raw", "npz"])
def test_planetoid_loaders_match_jax(tmp_path, monkeypatch, fmt):
    from graphneuralnetworks_tpu.data import datasets as jds
    from graphneuralnetworks_tpu_torch.data import datasets as tds
    from test_dataset_loaders import _write_planetoid

    if fmt == "raw":
        _write_planetoid(str(tmp_path))
    else:
        rng = np.random.default_rng(0)
        np.savez(tmp_path / "cora.npz", x=rng.random((9, 4)),
                 y=rng.integers(0, 3, 9),
                 edge_index=rng.integers(0, 9, (2, 20)),
                 train_mask=rng.random(9) < 0.5, val_mask=np.ones(9, bool),
                 test_mask=rng.random(9) < 0.5)
    monkeypatch.setenv("GNN_CORA_DIR", str(tmp_path))
    jd, j_real = jds.load_cora()
    td, t_real = tds.load_cora(device="cpu")
    assert j_real and t_real and td.num_classes == jd.num_classes
    n, ne = int(jd.graph.num_nodes), int(jd.graph.num_edges)
    g = td.graph
    assert (g.num_nodes, g.num_edges) == (n, ne)
    np.testing.assert_array_equal(g.senders.numpy(),
                                  np.asarray(jd.graph.senders)[:ne])
    np.testing.assert_array_equal(g.receivers.numpy(),
                                  np.asarray(jd.graph.receivers)[:ne])
    np.testing.assert_allclose(g.x.numpy(), np.asarray(jd.graph.x)[:n])
    np.testing.assert_array_equal(g.nodes["y"].numpy(),
                                  np.asarray(jd.graph.nodes["y"])[:n])
    for k in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      getattr(jd, k)[:n])


def _cora_model(name, din, nh, nout):
    kw = dict(generator=torch.Generator().manual_seed(17), device="cpu")
    head = torch.nn.Linear(nh, nout)
    if name == "GCN":
        return TM.GNNChain(TM.GCNConv(din, nh, torch.relu, **kw),
                           TM.GCNConv(nh, nh, torch.relu, **kw), head)
    if name == "GraphConv":
        return TM.GNNChain(TM.GraphConv(din, nh, torch.relu, **kw),
                           TM.GraphConv(nh, nh, torch.relu, **kw), head)
    if name == "SAGE":
        return TM.GNNChain(TM.SAGEConv(din, nh, torch.relu, **kw),
                           TM.SAGEConv(nh, nh, torch.relu, **kw), head)
    return TM.GNNChain(TM.GINConv(TM.MLP([din, nh], **kw), 0.01),
                       TM.GINConv(TM.MLP([nh, nh], **kw), 0.01), head)


@pytest.mark.parametrize("name", ["GCN", "GraphConv", "SAGE", "GIN"])
def test_cora_accuracy_bar(name):
    torch.manual_seed(17)
    data, _ = load_cora(seed=1, device="cpu")
    g = data.graph
    x, y = g.x, g.nodes["y"]
    model = _cora_model(name, x.shape[1], 16, data.num_classes)
    step = TT.make_train_step(
        model, torch.optim.Adam(model.parameters(), 1e-2),
        lambda m, g, x, y, k: TT.masked_cross_entropy(m(g, x), y, k))
    for _ in range(40):
        step(g, x, y, data.train_mask)
    with torch.no_grad():
        logits = model(g, x)
    train_acc = float(TT.masked_accuracy(logits, y, data.train_mask))
    test_acc = float(TT.masked_accuracy(logits, y, data.test_mask))
    # the reference CI bar (node_classification_cora.jl:100-101)
    assert train_acc > 0.94, f"{name}: train acc {train_acc}"
    assert test_acc > 0.69, f"{name}: test acc {test_acc}"
