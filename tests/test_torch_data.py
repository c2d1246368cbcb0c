"""The port's data layer vs the JAX package: ``DataLoader``, the dataset
readers, and one step of each example that uses them.

- ``DataLoader``: the same graphs in each batch, in the same order, for one
  and two buckets, with and without shuffling, over two epochs; the short
  batches' empty filler graphs included (they count in ``num_graphs``).
- The readers, on the fixtures that ``tests/test_dataset_loaders.py``
  writes (its writers are imported): TUDataset, OGB (raw CSV and npz, and
  feeding ``NeighborLoader``), METR-LA (h5 and npz), TemporalBrains (npz
  and split files), ``mldataset_to_graph``, and the ``load_*`` searchers
  with the files absent and present.
- One step of examples/link_prediction.py (split, negatives, GCN encoder,
  ``DotDecoder``, binary cross-entropy) and one batch of
  examples/graph_classification.py with filler graphs (``GlobalPool`` mean
  and max over empty graphs), forward and parameter gradients in float64,
  the weights carried by ``interop.load_jax_params``.
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import data as jdata  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu import training as JT  # noqa: E402
from graphneuralnetworks_tpu_torch import data as tdata  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import training as TT  # noqa: E402
from test_dataset_loaders import (_write_metrla_h5,  # noqa: E402
                                  _write_ogbn_raw, _write_tudataset)
from torch_parity import (F64_TOL, assert_grads_match,  # noqa: E402
                          assert_same_graph, jax_params_f64, pad_rows,
                          port_from_jax, t)

KW = dict(device="cpu", dtype=torch.float64)


# ---- DataLoader ------------------------------------------------------------

def _datasets(n=45, seed=0):
    return (jdata.synthetic_tudataset(n, seed=seed)[0],
            tdata.synthetic_tudataset(n, seed=seed, device="cpu")[0])


@pytest.mark.parametrize("num_buckets", [1, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match_jax(num_buckets, shuffle):
    jg, tg = _datasets()
    jl = jdata.DataLoader(jg, batch_size=8, shuffle=shuffle, seed=1,
                          num_buckets=num_buckets)
    tl = tdata.DataLoader(tg, batch_size=8, shuffle=shuffle, seed=1,
                          num_buckets=num_buckets, device="cpu")
    assert len(tl) == len(jl)
    for _ in range(2):                      # the draws go on across epochs
        jbs, tbs = list(jl), list(tl)
        assert len(tbs) == len(jbs) == len(tl)
        for jb, tb in zip(jbs, tbs):
            assert tb.num_graphs == 8
            assert_same_graph(jb, tb)


def test_dataloader_fills_short_batches_with_empty_graphs():
    _, tg = _datasets(75)
    tl = tdata.DataLoader(tg, batch_size=32, shuffle=True, seed=1,
                          num_buckets=2, device="cpu")
    empty = []
    for tb in tl:
        sizes = (tb.indptr_g[1:] - tb.indptr_g[:-1]).tolist()
        empty.append(sum(n == 0 for n in sizes))
        assert tb.num_graphs == 32 and tb.globals_["y"].shape == (32,)
    # buckets of 38 and 37 graphs: 32 + 6 and 32 + 5 real graphs
    assert sorted(empty) == [0, 0, 26, 27]


def test_dataloader_defaults_to_the_card(monkeypatch):
    _, tg = _datasets(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.DataLoader(tg)


# ---- readers ---------------------------------------------------------------

def test_tudataset_from_files_matches_jax(tmp_path):
    _write_tudataset(str(tmp_path))
    jg, jy = jdata.tudataset_from_files(str(tmp_path), "TOY")
    tg, ty = tdata.tudataset_from_files(str(tmp_path), "TOY", device="cpu")
    np.testing.assert_array_equal(ty, jy)
    assert len(tg) == len(jg) == 2
    for a, b in zip(jg, tg):
        assert_same_graph(a, b)


def test_mldataset_to_graph_matches_jax():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, 6, (2, 10))
    attrs = SimpleNamespace(num_nodes=6, edge_index=ei,
                            x=rng.standard_normal((6, 3)),
                            y=rng.integers(0, 2, 6),
                            edge_attr=rng.standard_normal((10, 2)))
    dicts = SimpleNamespace(num_nodes=6, edge_index=ei,
                            node_data={"h": np.arange(6.0)},
                            edge_data={"w": np.arange(10.0)})
    for obj in (attrs, dicts, SimpleNamespace(graphs=[attrs])):
        assert_same_graph(jdata.mldataset_to_graph(obj),
                          tdata.mldataset_to_graph(obj, device="cpu"))


def _same_large(a, b):
    for k in ("senders", "receivers", "x", "y"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.num_nodes == b.num_nodes and set(a.splits) == set(b.splits)
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])


def test_ogbn_from_files_matches_jax(tmp_path):
    _write_ogbn_raw(str(tmp_path))
    raw = tdata.ogbn_from_files(str(tmp_path))
    _same_large(jdata.ogbn_from_files(str(tmp_path)), raw)
    np.savez(tmp_path / "ogbn.npz",
             edge_index=np.stack([raw.senders, raw.receivers]),
             node_feat=raw.x, node_label=raw.y,
             train_idx=raw.splits["train"], valid_idx=raw.splits["valid"],
             test_idx=raw.splits["test"])
    npz = tdata.ogbn_from_files(str(tmp_path))        # the npz comes first
    _same_large(jdata.ogbn_from_files(str(tmp_path)), npz)
    _same_large(raw, npz)


def test_ogbn_feeds_neighbor_loader(tmp_path):
    _write_ogbn_raw(str(tmp_path))
    d = tdata.ogbn_from_files(str(tmp_path))
    shim = SimpleNamespace(num_nodes=d.num_nodes, num_edges=len(d.senders),
                           senders=d.senders, receivers=d.receivers,
                           nodes={}, edges={}, edge_weight=None)
    loader = tgnn.NeighborLoader(shim, num_neighbors=[2], batch_size=2,
                                 input_nodes=d.splits["train"], seed=0,
                                 device="cpu")
    batches = list(loader)
    assert len(batches) == 2
    for gb in batches:
        assert gb.nodes["NID"].max() < d.num_nodes
        assert gb.device.type == "cpu"


def test_metrla_from_files_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    _write_metrla_h5(str(tmp_path))
    for _ in range(2):
        a = jdata.metrla_from_files(str(tmp_path))
        b = tdata.metrla_from_files(str(tmp_path))
        for k in ("senders", "receivers", "edge_weight", "signal",
                  "timestamps"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        assert a.num_nodes == b.num_nodes == 5
        np.savez(tmp_path / "metrla.npz", signal=a.signal[:, :, 0] * 2,
                 adj=np.eye(5, dtype=np.float32))    # the npz comes first


def _write_temporalbrains(d, split=False):
    rng = np.random.default_rng(0)
    S, T, N = 3, 2, 6
    activity = rng.standard_normal((S, T, N)).astype(np.float32)
    ptr, ss, rr = [0], [], []
    for _ in range(S * T):
        e = int(rng.integers(3, 9))
        ss += list(rng.integers(0, N, e))
        rr += list(rng.integers(0, N, e))
        ptr.append(len(ss))
    edges = dict(edge_ptr=np.asarray(ptr, np.int64),
                 senders=np.asarray(ss, np.int32),
                 receivers=np.asarray(rr, np.int32))
    if split:
        np.save(d / "activity.npy", activity)
        np.save(d / "labels.npy", np.asarray([1, 0, 1], np.int32))
        np.savez(d / "edges.npz", **edges)
    else:
        np.savez(d / "temporalbrains.npz", activity=activity,
                 labels=np.array(["M", "F", "m"]), **edges)


@pytest.mark.parametrize("split", [False, True])
def test_temporalbrains_from_files_matches_jax(tmp_path, split):
    _write_temporalbrains(tmp_path, split)
    a = jdata.temporalbrains_from_files(str(tmp_path))
    b = tdata.temporalbrains_from_files(str(tmp_path))
    for k in ("activity", "labels", "edge_ptr", "senders", "receivers"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    assert b.labels.tolist() == [1, 0, 1]
    for i in range(b.num_subjects):
        ja, tb = a.subject(i), b.subject(i, device="cpu")
        assert int(tb.tgdata["y"]) == int(ja.tgdata["y"])
        assert tb.num_snapshots == ja.num_snapshots == 2
        for jg, tg in zip(ja.snapshots, tb.snapshots):
            assert_same_graph(jg, tg)


def test_loaders_search_and_are_graceful(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    for env, load in (("GNN_OGBN_PRODUCTS_DIR", tdata.load_ogbn_products),
                      ("GNN_METRLA_DIR", tdata.load_metrla),
                      ("GNN_TEMPORALBRAINS_DIR", tdata.load_temporalbrains)):
        monkeypatch.setenv(env, str(tmp_path / "nope"))
        assert load() == (None, False)
        (tmp_path / env).mkdir()                  # a directory, no files
        monkeypatch.setenv(env, str(tmp_path / env))
        assert load() == (None, False)
    _write_ogbn_raw(str(tmp_path / "GNN_OGBN_PRODUCTS_DIR"))
    _write_temporalbrains(tmp_path / "GNN_TEMPORALBRAINS_DIR")
    for load in (tdata.load_ogbn_products, tdata.load_temporalbrains):
        data, real = load()
        assert real and data is not None


def test_data_exports_match_jax():
    assert set(jdata.__all__) <= set(tdata.__all__)
    assert set(tdata.__all__) - set(jdata.__all__) == {
        "NodeClassificationData"}
    for name in tdata.__all__:
        assert hasattr(tdata, name), name


# ---- the two examples ------------------------------------------------------

def test_link_prediction_step_matches_jax():
    """examples/link_prediction.py's loss on a split graph and its
    negatives (GCN encoder, DotDecoder, BCE), forward and gradients."""
    n, din = 48, 6
    x = np.random.default_rng(1).standard_normal((n, din))
    jg = jgnn.rand_graph(n, 300, seed=3)
    tg = tgnn.rand_graph(n, 300, seed=3, device="cpu")
    jtr, jte = jgnn.rand_edge_split(jg, 0.9, rng=np.random.default_rng(0))
    ttr, tte = tgnn.rand_edge_split(tg, 0.9, rng=np.random.default_rng(0))
    jneg = jgnn.negative_sample(jtr, num_neg_edges=int(jtr.num_edges),
                                rng=np.random.default_rng(7))
    tneg = tgnn.negative_sample(ttr, num_neg_edges=ttr.num_edges,
                                rng=np.random.default_rng(7))
    assert_same_graph(jneg, tneg)
    assert_same_graph(jte, tte)

    r = nnx.Rngs(0)
    jenc = jax_params_f64(JM.GNNChain(JM.GCNConv(din, 8, jax.nn.relu,
                                                 rngs=r),
                                      JM.GCNConv(8, 4, rngs=r)))
    tenc = port_from_jax(TM.GNNChain(TM.GCNConv(din, 8, torch.relu, **KW),
                                     TM.GCNConv(8, 4, **KW)), jenc)

    def bce(logits, target, mask):
        z = jax.nn.log_sigmoid(logits)
        zm = jax.nn.log_sigmoid(-logits)
        loss = -(target * z + (1 - target) * zm)
        return jnp.sum(loss * mask) / jnp.maximum(jnp.sum(mask), 1)

    gd, params, rest = nnx.split(jenc, nnx.Param, ...)
    jdec = JM.DotDecoder()

    def jloss(p):
        h = nnx.merge(gd, p, rest)(jtr, jnp.asarray(pad_rows(x, jtr.n_pad)))
        pos = jdec(jtr, h)[:, 0]
        neg = jdec(jneg, h[:jneg.n_pad])[:, 0]
        return (bce(pos, 1.0, jtr.edge_mask)
                + bce(neg, 0.0, jneg.edge_mask)), (pos, neg)

    (jl, (jpos, jneg_s)), gp = jax.value_and_grad(jloss, has_aux=True)(
        params)

    h = tenc(ttr, t(x))
    dec = TM.DotDecoder()
    pos, neg = dec(ttr, h)[:, 0], dec(tneg, h)[:, 0]
    loss = -(torch.nn.functional.logsigmoid(pos).mean()
             + torch.nn.functional.logsigmoid(-neg).mean())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **F64_TOL)
    np.testing.assert_allclose(pos.detach().numpy(),
                               np.asarray(jpos)[:ttr.num_edges], **F64_TOL)
    np.testing.assert_allclose(neg.detach().numpy(),
                               np.asarray(jneg_s)[:tneg.num_edges],
                               **F64_TOL)
    assert_grads_match(tenc, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)


@pytest.mark.parametrize("aggr", ["mean", "max"])
def test_graph_classification_batch_with_fillers_matches_jax(aggr):
    """A short batch of examples/graph_classification.py's loader (filler
    graphs in it) through its model and loss, forward and gradients: the
    fillers' pooled rows and their part of the loss included."""
    jg, tg = _datasets(11, seed=4)
    jb = next(iter(jdata.DataLoader(jg, batch_size=8, shuffle=True, seed=1,
                                    num_buckets=2)))
    tb = next(iter(tdata.DataLoader(tg, batch_size=8, shuffle=True, seed=1,
                                    num_buckets=2, device="cpu")))
    assert_same_graph(jb, tb)
    sizes = (tb.indptr_g[1:] - tb.indptr_g[:-1]).tolist()
    assert 0 in sizes and tb.num_graphs == 8

    r = nnx.Rngs(5)
    jm = jax_params_f64(JM.GNNChain(
        JM.GraphConv(7, 8, jax.nn.relu, rngs=r),
        JM.GraphConv(8, 8, jax.nn.relu, rngs=r), JM.GlobalPool(aggr),
        nnx.Linear(8, 2, rngs=r)))
    tm = port_from_jax(TM.GNNChain(
        TM.GraphConv(7, 8, torch.relu, **KW),
        TM.GraphConv(8, 8, torch.relu, **KW), TM.GlobalPool(aggr),
        torch.nn.Linear(8, 2, dtype=torch.float64)), jm)
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p):
        logits = nnx.merge(gd, p, rest)(jb, jb.x.astype(jnp.float64))
        return JT.masked_cross_entropy(logits, jb.globals_["y"],
                                       jb.graph_mask), logits

    (jl, jlogits), gp = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tm(tb, tb.x.double())
    loss = TT.masked_cross_entropy(logits, tb.globals_["y"], tb.graph_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **F64_TOL)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits)[:8], **F64_TOL)
    assert_grads_match(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(gp)),
                       **F64_TOL)
