"""The port's host sampling against the JAX package's (CPU).

- ``sample_neighbors`` (both ``dir``s, with and without ``replace`` and
  ``dropnodes``) and ``induced_subgraph``: the same edges, ``EID``, ``NID``,
  features and weights as JAX for the same ``np.random.Generator``. Both
  packages sort a graph's edges by receiver (stable), so the edges compare
  in that order.
- The C++ sampler: the port builds its own copy into the repository's
  ``build/``, and its ``(nid, es, er, eid)`` equal JAX's
  ``native.sample_layers`` bit for bit (one RNG, in the C++), repeated
  seeds included.
- ``NeighborLoader``: ``epoch_batches`` and every batch of an epoch equal
  JAX's for one ``seed`` (native route, and the Python route forced on both
  sides); ``from_csr`` equals the default build; ``minimal_batch`` drops
  what JAX drops; a sampler library that cannot be built raises.
- ``Prefetcher``: every batch arrives, ``workers=2`` through the protocol,
  ``host_busy_s``, and its ``ValueError``.
- ``device_graph`` (the groupings built on the batch's device, here CPU
  tensors) equals ``graph``'s arrays exactly, stable tie order included:
  unsorted receivers from repeated seeds, an empty graph, isolated nodes.
- Three Adam steps of two-layer SAGE over loader batches match JAX's
  ``make_train_step`` over the same batches (float64, F64_TOL).
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
from graphneuralnetworks_tpu import native as jnative  # noqa: E402
from graphneuralnetworks_tpu import sampling as JS  # noqa: E402
from graphneuralnetworks_tpu import training as JT  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import native as tnative  # noqa: E402
from graphneuralnetworks_tpu_torch import sampling as TS  # noqa: E402
from graphneuralnetworks_tpu_torch import training as TT  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from torch_parity import (F64_TOL, jax_params_f64,  # noqa: E402
                          port_from_jax, pure_params)


def _pair(seed=0, n=60, e=400, isolated=5):
    """One weighted directed multigraph with node and edge features as a
    JAX graph and a port graph (CPU); the last ``isolated`` nodes have no
    edges."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - isolated, e)
    r = rng.integers(0, n - isolated, e)
    w = rng.random(e) + 0.5
    x = rng.standard_normal((n, 3))
    ef = rng.standard_normal((e, 2))
    jg = jgnn.graph(s, r, num_nodes=n, edge_weight=w, nodes={"x": x},
                    edges={"e": ef})
    tg = tgnn.graph(s, r, num_nodes=n, edge_weight=w, nodes={"x": x},
                    edges={"e": ef}, device="cpu")
    return jg, tg


def _same_graph(jg, tg, node_keys=(), edge_keys=()):
    """``tg`` equals ``jg`` on its real nodes and edges."""
    n, ne = int(jg.num_nodes), int(jg.num_edges)
    assert (tg.num_nodes, tg.num_edges) == (n, ne)
    np.testing.assert_array_equal(tg.senders.numpy(),
                                  np.asarray(jg.senders)[:ne])
    np.testing.assert_array_equal(tg.receivers.numpy(),
                                  np.asarray(jg.receivers)[:ne])
    if jg.edge_weight is None:
        assert tg.edge_weight is None
    else:
        np.testing.assert_array_equal(tg.edge_weight.numpy(),
                                      np.asarray(jg.edge_weight)[:ne])
    assert set(tg.nodes) == set(node_keys)
    assert set(tg.edges) == set(edge_keys)
    for k in node_keys:
        np.testing.assert_array_equal(tg.nodes[k].numpy(),
                                      np.asarray(jg.nodes[k])[:n])
    for k in edge_keys:
        np.testing.assert_array_equal(tg.edges[k].numpy(),
                                      np.asarray(jg.edges[k])[:ne])


@pytest.mark.parametrize("dropnodes", [False, True])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("dir", ["in", "out"])
def test_sample_neighbors_matches_jax(dir, replace, dropnodes):
    jg, tg = _pair(1)
    seeds = np.array([0, 3, 7, 11, 20, 33, 41, 57, 3])
    kw = dict(dir=dir, replace=replace, dropnodes=dropnodes)
    js = JS.sample_neighbors(jg, seeds, 4, rng=np.random.default_rng(5),
                             **kw)
    ts = tgnn.sample_neighbors(tg, seeds, 4, rng=np.random.default_rng(5),
                               **kw)
    _same_graph(js, ts, ("x", "NID") if dropnodes else ("x",), ("e", "EID"))
    assert ts.device.type == "cpu" and ts.num_edges > 0


def test_sample_neighbors_all_edges():
    jg, tg = _pair(2)
    ts = tgnn.sample_neighbors(tg, np.arange(60), -1,
                               rng=np.random.default_rng(0))
    js = JS.sample_neighbors(jg, np.arange(60), -1,
                             rng=np.random.default_rng(0))
    assert ts.num_edges == tg.num_edges
    _same_graph(js, ts, ("x",), ("e", "EID"))


def test_induced_subgraph_matches_jax():
    jg, tg = _pair(3)
    nodes = np.array([1, 4, 5, 8, 13, 21, 34, 55, 2, 40])
    _same_graph(JS.induced_subgraph(jg, nodes),
                tgnn.induced_subgraph(tg, nodes), ("x",), ("e",))


def _csr(n=80, e=600, seed=4, isolated=6):
    """An in-edge CSR ``(csr_send, csr_eid, ptr)`` with the last
    ``isolated`` nodes receiving nothing."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n - isolated, e)
    order = np.argsort(r, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return s[order].astype(np.int32), order.astype(np.int32), ptr, s, r


def test_native_sampler_builds_into_the_repository():
    from graphneuralnetworks_tpu_torch.ops.cuda import build as B

    assert tnative.available()
    lib = tnative._lib()
    assert str(B.BUILD_DIR) in lib._name and "graphneuralnetworks_tpu/" \
        not in lib._name


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("seeds", [[0, 5, 9, 17, 33], [3, 8, 3, 77, 8, 3]],
                         ids=["distinct", "repeated"])
def test_native_sampler_matches_jax(replace, seeds):
    cs, ce, ptr, s, r = _csr()
    seeds = np.array(seeds)
    got = tnative.sample_layers(cs, ce, ptr, seeds, [4, 3], replace, 42)
    want = jnative.sample_layers(cs, ce, ptr, seeds, [4, 3], replace, 42)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nid, es, er, eid = got
    # the sampled edges are edges of the graph, by their ids
    np.testing.assert_array_equal(nid[es], s[eid])
    np.testing.assert_array_equal(nid[er], r[eid])


def _loaders(**kw):
    jg, tg = _pair(6, n=150, e=1500)
    args = dict(num_neighbors=[3, 2], batch_size=16, seed=7, **kw)
    return (JS.NeighborLoader(jg, **args), tgnn.NeighborLoader(tg, **args),
            tg)


def test_epoch_batches_match_jax():
    jl, tl, _ = _loaders(input_nodes=np.arange(3, 140))
    assert len(jl) == len(tl)
    for _ in range(2):
        for a, b in zip(jl.epoch_batches(), tl.epoch_batches()):
            np.testing.assert_array_equal(a, b)


def _force_python(monkeypatch):
    monkeypatch.setattr(jnative, "sample_layers", None)
    monkeypatch.setattr(tnative, "sample_layers", None)


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("route", ["native", "python"])
def test_loader_batches_match_jax(monkeypatch, route, replace):
    if route == "python":
        _force_python(monkeypatch)
    jl, tl, tg = _loaders(replace=replace)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl)
    for a, b in zip(jb, tb):
        _same_graph(a, b, ("NID", "seed_mask", "x"), ("EID", "e"))
        assert b.device == tg.device
        nid = b.nodes["NID"].numpy()
        np.testing.assert_array_equal(b.nodes["x"].numpy(),
                                      tg.x.numpy()[nid])


def test_in_csr_matches_the_loaders_numpy_build():
    """The CSR built with a stable torch.sort (on the card at ogbn scale)
    equals the loader's numpy argsort build, ties in edge order."""
    rng = np.random.default_rng(9)
    n, e = 70, 900
    s, r = rng.integers(0, n, e), rng.integers(0, n - 8, e) ** 2 % (n - 8)
    g = tgnn.graph(s, r, num_nodes=n, device="cpu")
    want = tgnn.NeighborLoader(g, num_neighbors=[2]).csr
    got = TS.in_csr(torch.from_numpy(s), torch.from_numpy(r), n)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[2].dtype == torch.int64
    ref_order = np.argsort(r, kind="stable")
    ref_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    np.testing.assert_array_equal(TS._csr_by(r, n)[0], ref_order)
    np.testing.assert_array_equal(TS._csr_by(r, n)[1], ref_ptr)
    np.testing.assert_array_equal(got[1].numpy(), ref_order)
    np.testing.assert_array_equal(got[0].numpy(), s[ref_order])
    np.testing.assert_array_equal(got[2].numpy(), ref_ptr)
    # the loader's own build (over g's receiver-sorted edges) has the same
    # senders and offsets
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_from_csr_matches_default():
    rng = np.random.default_rng(3)
    n, e = 60, 240
    g = tgnn.graph(rng.integers(0, n, e), rng.integers(0, n, e),
                   num_nodes=n, device="cpu")
    kw = dict(num_neighbors=[3, 2], batch_size=8, seed=7,
              input_nodes=np.arange(24), minimal_batch=True)
    a = tgnn.NeighborLoader(g, **kw)
    b = tgnn.NeighborLoader.from_csr(*(c.copy() for c in a.csr),
                                     num_nodes=n, device="cpu", **kw)
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in ("senders", "receivers", "indptr_r", "col_r", "indptr_s",
                  "col_s", "eid_s"):
            assert torch.equal(getattr(ga, f), getattr(gb, f)), f
        assert torch.equal(ga.nodes["NID"], gb.nodes["NID"])


def test_minimal_batch_drops_what_jax_drops():
    jl, tl, _ = _loaders(minimal_batch=True)
    for a, b in zip(jl, tl):
        _same_graph(a, b, ("NID",), ())
        assert b.edge_weight is None and a.edge_weight is None


def test_loader_raises_without_native_library(monkeypatch):
    def unavailable():
        raise RuntimeError("g++ failed for sampler.cc")

    monkeypatch.setattr(tnative, "_lib", unavailable)
    _, tl, _ = _loaders()
    with pytest.raises(RuntimeError, match="sampler"):
        next(iter(tl))
    assert not tnative.available()


def test_prefetcher_delivers_every_batch():
    _, tl, _ = _loaders(minimal_batch=True)
    want = list(_loaders(minimal_batch=True)[1])
    pf = TS.Prefetcher(tl, size=2)
    got = list(pf)
    assert len(pf) == len(tl) == len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.senders, b.senders)
        assert torch.equal(a.nodes["NID"], b.nodes["NID"])
    assert pf.host_busy_s > 0


def test_prefetcher_workers_use_the_protocol():
    _, tl, _ = _loaders(minimal_batch=True)
    want = _loaders(minimal_batch=True)[1].epoch_batches()
    pf = TS.Prefetcher(tl, size=2, workers=2)
    got = list(pf)
    assert len(got) == len(tl) == len(want)
    # out of order, but each epoch batch's (distinct) seeds lead one NID
    bs = tl.batch_size
    assert sorted(tuple(g.nodes["NID"][:bs].tolist()) for g in got) == \
        sorted(tuple(w.tolist()) for w in want)
    assert pf.host_busy_s > 0


def test_prefetcher_errors():
    with pytest.raises(ValueError, match="protocol"):
        TS.Prefetcher([1, 2, 3], workers=2)

    def broken():
        yield 1
        raise KeyError("producer failed")

    with pytest.raises(KeyError, match="producer failed"):
        list(TS.Prefetcher(broken()))


def _same_groupings(a, b):
    for f in ("senders", "receivers", "node_graph_id", "indptr_r", "col_r",
              "indptr_s", "col_s", "eid_s", "indptr_g", "indptr_ge",
              "edge_weight"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        assert x.dtype == y.dtype, f
        assert torch.equal(x, y), f
    assert (a.num_nodes, a.num_edges, a.num_graphs) == \
        (b.num_nodes, b.num_edges, b.num_graphs)
    for k in a.edges:
        assert torch.equal(a.edges[k], b.edges[k]), k


def _numpy_groupings(s, r, n):
    """The groupings by numpy's stable argsort and bincount, independent of
    the package's torch build."""
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    by_s = np.argsort(s, kind="stable")

    def indptr(keys):
        return np.concatenate([[0], np.cumsum(np.bincount(
            keys, minlength=n))]).astype(np.int32)

    return order, {"senders": s, "receivers": r, "indptr_r": indptr(r),
                   "col_r": s.astype(np.int32), "indptr_s": indptr(s),
                   "col_s": r[by_s].astype(np.int32),
                   "eid_s": by_s.astype(np.int32)}


@pytest.mark.parametrize("case", ["repeated_seeds", "empty", "isolated"])
def test_device_graph_equals_graph(case):
    if case == "repeated_seeds":
        # a repeated seed keeps its first local id: its edges come again
        # after others, so the receivers are not sorted
        cs, ce, ptr, _, _ = _csr()
        _, es, er, eid = tnative.sample_layers(
            cs, ce, ptr, np.array([3, 8, 3, 8, 40]), [4, 3], False, 1)
        assert np.any(np.diff(er) < 0)
        n = int(max(es.max(), er.max())) + 1
        s, r = es, er
        w = np.random.default_rng(0).random(len(es))
    elif case == "empty":
        n, s, r, w = 7, np.zeros(0, np.int32), np.zeros(0, np.int32), None
    else:
        rng = np.random.default_rng(2)
        n, s, r = 30, rng.integers(0, 10, 50), rng.integers(0, 10, 50)
        w = rng.random(50)
    ef = np.arange(2 * len(s), dtype=np.float64).reshape(-1, 2)
    host = tgnn.graph(s, r, num_nodes=n, edge_weight=w, edges={"e": ef},
                      device="cpu")
    dev = tgnn.device_graph(
        torch.from_numpy(np.asarray(s)), torch.from_numpy(np.asarray(r)),
        num_nodes=n, edges={"e": torch.from_numpy(ef)},
        edge_weight=None if w is None else torch.from_numpy(w))
    _same_groupings(host, dev)
    order, want = _numpy_groupings(s, r, n)
    for f, a in want.items():
        got = getattr(host, f)
        assert got.dtype == torch.from_numpy(a).dtype, f
        np.testing.assert_array_equal(got.numpy(), a, err_msg=f)
    np.testing.assert_array_equal(host.edges["e"].numpy(), ef[order])
    if w is not None:
        np.testing.assert_array_equal(host.edge_weight.numpy(), w[order])


def test_sage_steps_over_loader_batches_match_jax():
    """Three Adam steps of SAGEConv -> SAGEConv -> Dense over three loader
    batches, the loss on the seed rows, float64 on the XLA path and the
    port's plain path: the loss at each step and the final parameters."""
    n, din, nh, ncls, bs = 150, 5, 8, 3, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, din))
    y = rng.integers(0, ncls, n)
    jl, tl, _ = _loaders(minimal_batch=True)

    r = nnx.Rngs(3)
    jm = jax_params_f64(JM.GNNChain(
        JM.SAGEConv(din, nh, jax.nn.relu, rngs=r),
        JM.SAGEConv(nh, nh, jax.nn.relu, rngs=r), nnx.Linear(nh, ncls,
                                                             rngs=r)))
    kw = dict(device="cpu", dtype=torch.float64)
    tm = port_from_jax(TM.GNNChain(
        TM.SAGEConv(din, nh, torch.relu, **kw),
        TM.SAGEConv(nh, nh, torch.relu, **kw),
        torch.nn.Linear(nh, ncls, dtype=torch.float64)), jm)

    def jloss(m, g, X, Y):
        nid = g.nodes["NID"]
        logits = m(g, X[nid])[:bs]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, Y[nid[:bs]]))

    def tloss(m, g, X, Y):
        nid = g.nodes["NID"].long()
        logits = m(g, X[nid])[:bs]
        return torch.nn.functional.cross_entropy(logits, Y[nid[:bs]])

    state = JT.TrainState(jm, optax.adam(1e-2))
    jstep = JT.make_train_step(state, jloss)
    tstep = TT.make_train_step(tm, torch.optim.Adam(tm.parameters(), 1e-2),
                               tloss)
    params, opt_state = state.params, state.opt_state
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.tensor(x), torch.tensor(y)
    for _, jb, tb in zip(range(3), jl, tl):
        params, opt_state, jl_ = jstep(params, opt_state, jb, jx, jy)
        tl_ = tstep(tb, tx, ty)
        np.testing.assert_allclose(float(tl_), float(jl_), **F64_TOL)
    want = load_jax_params(copy.deepcopy(tm), pure_params(state.model(params)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=name, **F64_TOL)
