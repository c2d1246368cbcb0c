"""The port's graph toolkit vs the JAX package: utils, transform, generate,
convert, operators and datastore.

The same numpy graphs and the same seeded generators feed both packages.
Structure and seeded draws must agree exactly: both store edges sorted by
receiver (stable), so edge arrays are compared in stored order. Floats
computed the same way agree exactly; ``random_walk_pe`` and
``ppr_diffusion`` in float64 agree at ``F64_TOL``.
"""

import warnings

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import query as jquery  # noqa: E402
from graphneuralnetworks_tpu import transform as JT  # noqa: E402
from graphneuralnetworks_tpu_torch import query as tquery  # noqa: E402
from graphneuralnetworks_tpu_torch import transform as TT  # noqa: E402
from torch_parity import F64_TOL, assert_same_graph  # noqa: E402


def multigraph(seed=0, n=30, e=120, features=True):
    """A directed multigraph with repeated pairs, self-loops, float64
    weights, float and integer edge features and node features; the
    last 3 nodes are isolated."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 3, e)
    r = rng.integers(0, n - 3, e)
    s[:10], r[:10] = s[10:20], r[10:20]          # repeated pairs
    s[20:24] = r[20:24]                          # self-loops
    kw = dict(num_nodes=n, edge_weight=rng.random(e) + 0.5,
              nodes={"x": rng.standard_normal((n, 3)),
                     "t": rng.integers(0, 5, n)})
    if features:
        kw["edges"] = {"e": rng.standard_normal((e, 2)),
                       "k": rng.integers(-4, 5, (e, 3))}
    return (jgnn.graph(s, r, **kw), tgnn.graph(s, r, device="cpu", **kw))


def bidirected_multigraph(seed=1, n=40, pairs=90):
    """A bidirected graph whose pairs repeat, with self-loops (also
    repeated): the case where ``rand_edge_split``'s reverse pick is the
    last copy of a key."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, pairs)
    b = rng.integers(0, n, pairs)
    a[:12], b[:12] = a[12:24], b[12:24]          # repeated pairs
    b[30:36] = a[30:36]                          # self-loops
    a[36:38], b[36:38] = a[30], a[30]            # a repeated self-loop
    s, r = np.concatenate([a, b]), np.concatenate([b, a])
    return (jgnn.graph(s, r, num_nodes=n),
            tgnn.graph(s, r, num_nodes=n, device="cpu"))


SURGERY = {
    "add_self_loops": lambda m, g, rng: m.add_self_loops(g, fill_weight=2.0),
    "remove_self_loops": lambda m, g, rng: m.remove_self_loops(g),
    "remove_edges": lambda m, g, rng: m.remove_edges(g, [0, 5, 7, 119]),
    "remove_edges_p": lambda m, g, rng: m.remove_edges(g, p=0.3, rng=rng),
    "remove_nodes": lambda m, g, rng: m.remove_nodes(g, [0, 4, 13, 29]),
    "add_edges": lambda m, g, rng: m.add_edges(
        g, [1, 25, 2], [26, 0, 2], edge_weight=[0.25, 0.5, 0.75],
        edges={"e": np.ones((3, 2)), "k": np.full((3, 3), 7)}),
    "add_nodes": lambda m, g, rng: m.add_nodes(
        g, 4, nodes={"x": np.full((4, 3), 2.0)}),
    "perturb_edges": lambda m, g, rng: m.perturb_edges(g, 0.2, rng=rng),
    "set_edge_weight": lambda m, g, rng: m.set_edge_weight(
        g, np.arange(g.num_edges, dtype=np.float64)),
    "to_bidirected": lambda m, g, rng: m.to_bidirected(g),
    "to_unidirected": lambda m, g, rng: m.to_unidirected(g),
    "sort_edge_index": lambda m, g, rng: m.sort_edge_index(g),
}


@pytest.mark.parametrize("name", sorted(SURGERY))
def test_edge_surgery_matches_jax(name):
    # add_self_loops and perturb_edges take no edge features (JAX raises
    # on the first; its add_edges needs the keys of the second)
    jg, tg = multigraph(features=name not in ("add_self_loops",
                                              "perturb_edges"))
    fn = SURGERY[name]
    assert_same_graph(fn(JT, jg, np.random.default_rng(5)),
                      fn(TT, tg, np.random.default_rng(5)))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min", "first"])
def test_remove_multi_edges_matches_jax(aggr):
    jg, tg = multigraph()
    out = TT.remove_multi_edges(tg, aggr=aggr)
    assert_same_graph(JT.remove_multi_edges(jg, aggr=aggr), out)
    assert not bool(tgnn.has_multi_edges(out))


def test_add_edges_and_nodes_grow_the_last_graph():
    graphs = [jgnn.rand_graph(5, 8, seed=i) for i in range(3)]
    tgraphs = [tgnn.rand_graph(5, 8, seed=i, device="cpu") for i in range(3)]
    jb, tb = jgnn.batch(graphs), tgnn.batch(tgraphs, device="cpu")
    out = TT.add_edges(tb, [16, 2], [3, 17])
    assert_same_graph(JT.add_edges(jb, [16, 2], [3, 17]), out)
    assert out.node_graph_id[-3:].tolist() == [2, 2, 2]
    assert_same_graph(JT.add_nodes(jb, 2), TT.add_nodes(tb, 2))


def test_batch_unbatch_getgraph_match_jax():
    rng = np.random.default_rng(3)
    specs = [(6, 10), (0, 0), (4, 6), (7, 12)]
    js, ts = [], []
    for i, (n, e) in enumerate(specs):
        s = rng.integers(0, max(n, 1), e)
        r = rng.integers(0, max(n, 1), e)
        kw = dict(num_nodes=n, nodes={"x": rng.standard_normal((n, 2))},
                  edges={"e": rng.standard_normal((e, 1))},
                  globals_={"y": np.asarray([i])})
        js.append(jgnn.graph(s, r, **kw))
        ts.append(tgnn.graph(s, r, device="cpu", **kw))
    jb, tb = JT.blockdiag(*js), TT.blockdiag(*ts, device="cpu")
    assert_same_graph(jb, tb)
    for jp, tp in zip(JT.unbatch(jb), TT.unbatch(tb)):
        assert_same_graph(jp, tp)
    assert_same_graph(JT.getgraph(jb, [3, 0, 2]), TT.getgraph(tb, [3, 0, 2]))


def test_is_bidirected_matches_jax():
    for jg, tg in (bidirected_multigraph(), multigraph()):
        h = JT._unpack(jg)
        assert TT._is_bidirected_np(tg.senders.numpy(), tg.receivers.numpy(),
                                    tg.num_nodes) == JT._is_bidirected_np(h)


@pytest.mark.parametrize("case", ["bidirected", "bidirected_multigraph",
                                  "directed", "directed_forced_pairs"])
def test_negative_sample_matches_jax(case):
    if case == "bidirected":
        jg = jgnn.rand_graph(60, 400, seed=4)
        tg = tgnn.rand_graph(60, 400, seed=4, device="cpu")
        kw = {}
    elif case == "bidirected_multigraph":
        jg, tg = bidirected_multigraph()
        kw = dict(num_neg_edges=301)
    else:
        jg, tg = multigraph(features=False)
        kw = dict(num_neg_edges=200)
        if case == "directed_forced_pairs":
            kw["bidirected"] = True
    for seed in (0, 1):
        jn = JT.negative_sample(jg, rng=np.random.default_rng(seed), **kw)
        tn = TT.negative_sample(tg, rng=np.random.default_rng(seed), **kw)
        assert_same_graph(jn, tn)
        assert tn.num_edges > 0
    # none of them is an edge or a self-loop
    ne = tg.num_edges
    pos = set(zip(tg.senders.tolist(), tg.receivers.tolist()))
    neg = list(zip(tn.senders.tolist(), tn.receivers.tolist()))
    assert not pos & set(neg) and all(a != b for a, b in neg)
    assert len(set(neg)) == len(neg) and ne


@pytest.mark.parametrize("bidirected", [True, False])
def test_negative_sample_shortfall_warns_as_jax(bidirected):
    # a 6-node graph with all but a few pairs taken
    s, r = np.nonzero(~np.eye(6, dtype=bool))
    keep = (s + r) % 5 != 0
    s, r = s[keep], r[keep]
    jg = jgnn.graph(s, r, num_nodes=6)
    tg = tgnn.graph(s, r, num_nodes=6, device="cpu")
    outs = []
    for m, g in ((JT, jg), (TT, tg)):
        with pytest.warns(UserWarning, match="non-edges exist") as rec:
            outs.append(m.negative_sample(g, num_neg_edges=20,
                                          bidirected=bidirected,
                                          rng=np.random.default_rng(2)))
        outs.append(str(rec[0].message))
    assert outs[1] == outs[3]
    assert_same_graph(outs[0], outs[2])


@pytest.mark.parametrize("case", ["bidirected", "bidirected_multigraph",
                                  "directed"])
def test_rand_edge_split_matches_jax(case):
    if case == "bidirected":
        jg = jgnn.rand_graph(50, 300, seed=6)
        tg = tgnn.rand_graph(50, 300, seed=6, device="cpu")
    elif case == "bidirected_multigraph":
        jg, tg = bidirected_multigraph()
    else:
        jg, tg = multigraph()
    for frac in (0.9, 0.37):
        ja, jb = JT.rand_edge_split(jg, frac, rng=np.random.default_rng(0))
        ta, tb = TT.rand_edge_split(tg, frac, rng=np.random.default_rng(0))
        assert_same_graph(ja, ta)
        assert_same_graph(jb, tb)
        assert ta.num_edges + tb.num_edges == tg.num_edges


def test_rand_edge_split_reverse_pick_is_the_last_copy():
    # (0, 1) twice, (1, 0) twice, and a self-loop (2, 2) three times: a
    # pick of an edge brings the LAST edge of its reverse key
    s = np.array([0, 1, 0, 1, 2, 2, 2])
    r = np.array([1, 0, 1, 0, 2, 2, 2])
    jg = jgnn.graph(s, r, num_nodes=3)
    tg = tgnn.graph(s, r, num_nodes=3, device="cpu")
    for seed in range(6):
        ja, jb = JT.rand_edge_split(jg, 0.5, rng=np.random.default_rng(seed))
        ta, tb = TT.rand_edge_split(tg, 0.5, rng=np.random.default_rng(seed))
        assert_same_graph(ja, ta)
        assert_same_graph(jb, tb)


def test_random_walk_pe_matches_jax(monkeypatch):
    jg, tg = multigraph(features=False)
    want32 = np.asarray(JT.random_walk_pe(jg, 4))[:tg.num_nodes]
    got32 = TT.random_walk_pe(tg, 4)
    assert got32.dtype == torch.float32 and got32.shape == (30, 4)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-5, atol=1e-6)
    # both functions build on query.adjacency_matrix and query.degree
    # (float32 by default): at float64 both packages agree to F64_TOL
    import jax.numpy as jnp
    for mod, f64 in ((jquery, jnp.float64), (tquery, torch.float64)):
        for name in ("adjacency_matrix", "degree"):
            f = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=f, _d=f64, **k: _f(
                *a, dtype=_d, **k))
    want = np.asarray(JT.random_walk_pe(jg, 4))[:tg.num_nodes]
    got = TT.random_walk_pe(tg, 4)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


def test_ppr_diffusion_matches_jax():
    jg, tg = multigraph(features=False)
    assert_same_graph(JT.ppr_diffusion(jg, alpha=0.7),
                      TT.ppr_diffusion(tg, alpha=0.7), weights_tol=F64_TOL)


def test_edge_valid_graphs_raise():
    _, tg = multigraph(features=False)
    tv = tg.replace(edge_valid=torch.ones(tg.num_edges, dtype=torch.bool))
    for fn in (TT.remove_self_loops, lambda g: TT.negative_sample(g),
               lambda g: TT.rand_edge_split(g, 0.5)):
        with pytest.raises(ValueError, match="edge_valid"):
            fn(tv)


def test_transforms_keep_the_graph_device_and_default_to_the_card(
        monkeypatch):
    _, tg = multigraph(features=False)
    assert TT.negative_sample(tg, rng=np.random.default_rng(0)).device \
        == tg.device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.knn_graph(np.zeros((4, 2)), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.from_adjacency_list([[1], [0]])


# ---- utils -----------------------------------------------------------------

@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("self_loops", [True, False])
def test_edge_encoding_matches_jax(directed, self_loops):
    n = 9
    s, r = np.nonzero(np.ones((n, n), bool))
    if not self_loops:
        s, r = s[s != r], r[s != r]
    if not directed:
        s, r = s[s <= r], r[s <= r]
    kw = dict(directed=directed, self_loops=self_loops)
    idx, maxid = tgnn.edge_encoding(s, r, n, **kw)
    jidx, jmax = jgnn.edge_encoding(s, r, n, **kw)
    np.testing.assert_array_equal(idx, jidx)
    assert maxid == jmax and sorted(idx.tolist()) == list(range(maxid))
    s2, r2 = tgnn.edge_decoding(idx, n, **kw)
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(r2, r)


def test_check_num_nodes_and_edges():
    _, tg = multigraph()
    tgnn.check_num_nodes(tg, torch.zeros(30, 2))
    tgnn.check_num_edges(tg, torch.zeros(120))
    with pytest.raises(ValueError, match="node count 30"):
        tgnn.check_num_nodes(tg, torch.zeros(32, 2))
    with pytest.raises(ValueError, match="edge count 120"):
        tgnn.check_num_edges(tg, torch.zeros(128))


@pytest.mark.parametrize("x0", [None, "labels"])
def test_color_refinement_matches_jax(x0):
    jg, tg = multigraph(features=False)
    x = None if x0 is None else np.arange(30) % 3
    colors, k, it = tgnn.color_refinement(tg, x)
    jcolors, jk, jit = jgnn.color_refinement(jg, x)
    np.testing.assert_array_equal(colors.numpy(), jcolors)
    assert (k, it) == (jk, jit) and colors.dtype == torch.int32


# ---- generate --------------------------------------------------------------

def test_knn_and_radius_graphs_match_jax():
    rng = np.random.default_rng(7)
    pts = rng.random((24, 3))
    gi = np.repeat([0, 1, 2], 8)
    for kw in (dict(), dict(graph_indicator=gi), dict(dir="out"),
               dict(self_loops=True)):
        assert_same_graph(jgnn.knn_graph(pts, 3, **kw),
                          tgnn.knn_graph(pts, 3, device="cpu", **kw))
        assert_same_graph(jgnn.radius_graph(pts, 0.4, **kw),
                          tgnn.radius_graph(pts, 0.4, device="cpu", **kw))


def test_temporal_generators_match_jax():
    pairs = [(jgnn.rand_temporal_radius_graph(
        20, 4, 0.1, 0.3, rng=np.random.default_rng(8)),
        tgnn.rand_temporal_radius_graph(
            20, 4, 0.1, 0.3, rng=np.random.default_rng(8), device="cpu")),
        (jgnn.rand_temporal_hyperbolic_graph(
            20, 3, alpha=0.5, R=4.0, speed=0.2,
            rng=np.random.default_rng(9)),
         tgnn.rand_temporal_hyperbolic_graph(
            20, 3, alpha=0.5, R=4.0, speed=0.2,
            rng=np.random.default_rng(9), device="cpu"))]
    for jt, tt in pairs:
        assert isinstance(tt, tgnn.TemporalGraph)
        assert tt.num_snapshots == jt.num_snapshots
        for jg, tg in zip(jt.snapshots, tt.snapshots):
            assert_same_graph(jg, tg)


# ---- convert, operators, datastore -----------------------------------------

def test_converters_match_jax():
    adj = [[1, 2], [], [0, 0, 3], [3]]
    assert_same_graph(jgnn.from_adjacency_list(adj),
                      tgnn.from_adjacency_list(adj, device="cpu"))
    jg, tg = multigraph(features=False)
    A, jA = tgnn.to_scipy_sparse(tg), jgnn.to_scipy_sparse(jg)
    np.testing.assert_allclose(A.toarray(), jA.toarray(), **F64_TOL)
    assert_same_graph(jgnn.from_scipy_sparse(jA),
                      tgnn.from_scipy_sparse(A, device="cpu"))
    np.testing.assert_array_equal(tgnn.to_dense_adjacency(tg),
                                  jgnn.to_dense_adjacency(jg))
    from graphneuralnetworks_tpu_torch import convert
    assert convert.from_dense_adjacency is tgnn.from_dense_adjacency


def test_intersect_graphs_matches_jax():
    j1, t1 = multigraph(0, features=False)
    j2, t2 = multigraph(1, n=33, features=False)
    j3 = JT.add_edges(j2, np.asarray(j1.senders)[:40],
                      np.asarray(j1.receivers)[:40])
    t3 = TT.add_edges(t2, t1.senders[:40], t1.receivers[:40])
    assert_same_graph(jgnn.intersect_graphs(j1, j3),
                      tgnn.intersect_graphs(t1, t3))


def test_datastore():
    ds = tgnn.DataStore(x=torch.ones(5, 3), y=torch.zeros(5))
    assert ds.n == 5 and ds.x.shape == (5, 3) and len(ds) == 2
    assert ds.getobs(torch.tensor([0, 2])).n == 2
    assert ds.getobs(np.arange(5) < 2).n == 2
    assert ds.map(lambda v: v * 2).x.sum() == 30
    cat = tgnn.DataStore.cat([ds, ds])
    assert isinstance(cat.x, torch.Tensor) and cat.n == 10
    arr = tgnn.DataStore.cat([tgnn.DataStore(a=np.ones(2)),
                              tgnn.DataStore(a=np.zeros(3))])
    assert isinstance(arr.a, np.ndarray) and arr.n == 5
    with pytest.raises(ValueError, match="n=5"):
        tgnn.DataStore(x=torch.ones(5), y=torch.ones(4))
    with pytest.raises(ValueError, match="missing"):
        tgnn.DataStore.cat([ds, tgnn.DataStore(x=torch.ones(1, 3))])
    with pytest.raises(AttributeError):
        ds.nope


# ---- exports ---------------------------------------------------------------

# the JAX package's names these modules leave out on purpose (ROADMAP.md,
# "Not to port")
NOT_PORTED = {"pad_sizes", "round_up"}
MODULES = ("transform", "generate", "convert", "operators", "datastore",
           "utils")


@pytest.mark.parametrize("module", MODULES)
def test_exports_match_jax(module):
    import importlib
    jm = importlib.import_module(f"graphneuralnetworks_tpu.{module}")
    tm = importlib.import_module(f"graphneuralnetworks_tpu_torch.{module}")
    assert set(tm.__all__) == set(jm.__all__) - NOT_PORTED
    # every name the JAX package exports from it, the port exports too
    for name in dir(jgnn):
        obj = getattr(jgnn, name)
        if getattr(obj, "__module__", None) == jm.__name__:
            assert name in tgnn.__all__ and hasattr(tgnn, name), name


def test_warnings_point_at_the_caller():
    _, tg = multigraph(features=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        TT.negative_sample(tg, num_neg_edges=10 ** 6,
                           rng=np.random.default_rng(0))
    assert rec and rec[0].filename == __file__
