"""Heterogeneous graphs and HeteroGraphConv against graphneuralnetworks_tpu.

The same numpy relations and features feed both packages on the CPU: the
JAX side with x64 (``tests/conftest.py``), padding each node type and
relation to its own capacity, the port in float64 at true size. Only real
rows and edges are compared, in the stored (receiver-sorted) edge order.

Tolerances: the container queries and transforms are exact (integer ids,
copied features); the layers are held at ``F64_TOL`` (float64 on both
sides, only the order of the sums differs).

The port builds each relation over ``max(N_src, N_dst)`` nodes (module
docstring of ``heterograph.py``), so the layer tests run type sizes that
differ both ways: a relation from the larger type into the smaller and one
from the smaller into the larger.
"""

import copy
import importlib
import importlib.util
import os

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
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import training as TT  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from torch_parity import (F64_TOL, jax_params_f64, pad_rows,  # noqa: E402
                          port_from_jax, pure_params, t)

TG = importlib.import_module("graphneuralnetworks_tpu_torch.graph")
KW = dict(device="cpu", dtype=torch.float64)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _relations(rng, sizes, counts):
    """``{etype: (s, r)}`` with uniform endpoints (repeats allowed)."""
    return {et: (rng.integers(0, sizes[et[0]], ne),
                 rng.integers(0, sizes[et[2]], ne))
            for et, ne in counts.items()}


def _pair(rels, sizes, **kw):
    return (jgnn.heterograph(rels, num_nodes=sizes, **kw),
            tgnn.heterograph(rels, num_nodes=sizes, device="cpu", **kw))


def _host(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _assert_same_graph(jg, tg):
    """Every type's count and node features, and every relation's edges,
    weights and edge features, in stored order; JAX's padding cut off."""
    assert tg.ntypes == jg.ntypes and tg.etypes == jg.etypes
    assert tg.num_node_types == jg.num_node_types
    assert tg.num_edge_types == jg.num_edge_types
    for nt in jg.ntypes:
        n = int(jg.num_nodes[nt])
        assert tg.num_nodes[nt] == n
        assert set(tg[nt]) == set(jg[nt])
        for k, v in jg[nt].items():
            np.testing.assert_array_equal(_host(tg[nt][k]),
                                          np.asarray(v)[:n])
    for et in jg.etypes:
        jr, tr = jg[et], tg[et]
        ne = int(jr.num_edges)
        assert tr.num_edges == ne
        js, jr_ = jg.edge_index(et)
        ts, tr_ = tg.edge_index(et)
        np.testing.assert_array_equal(_host(ts), np.asarray(js)[:ne])
        np.testing.assert_array_equal(_host(tr_), np.asarray(jr_)[:ne])
        assert np.all(np.diff(_host(tr_)) >= 0)
        assert (tr.edge_weight is None) == (jr.edge_weight is None)
        if jr.edge_weight is not None:
            np.testing.assert_array_equal(_host(tr.edge_weight),
                                          np.asarray(jr.edge_weight)[:ne])
        assert set(tr.data) == set(jr.data)
        for k, v in jr.data.items():
            np.testing.assert_array_equal(_host(tr.data[k]),
                                          np.asarray(v)[:ne])
    assert set(tg.graph_data) == set(jg.graph_data)
    for k, v in jg.graph_data.items():
        np.testing.assert_array_equal(_host(tg.graph_data[k]), np.asarray(v))


def _typed_graph(seed=0, weighted=False, features=False):
    """Three types of unequal sizes and four relations between them, with
    repeated edges (a multigraph) and a self relation."""
    rng = np.random.default_rng(seed)
    sizes = {"user": 9, "item": 14, "tag": 5}
    counts = {("user", "rates", "item"): 30, ("item", "rated_by", "user"): 25,
              ("user", "follows", "user"): 12, ("tag", "on", "item"): 11}
    rels = _relations(rng, sizes, counts)
    if weighted:
        rels = {et: (s, r, rng.random(len(s)) + 0.5)
                for et, (s, r) in rels.items()}
    kw = {}
    if features:
        kw["node_data"] = {t: {"x": rng.standard_normal((n, 3))}
                           for t, n in sizes.items()}
        kw["edge_data"] = {et: {"e": rng.standard_normal((c, 2))}
                           for et, c in counts.items() if et[1] != "on"}
    return rels, sizes, kw


@pytest.mark.parametrize("weighted", [False, True])
def test_heterograph_matches_jax(weighted):
    """Node features, each relation's receiver-sorted (stable) edges,
    weights and edge features, and the type and relation lists."""
    rels, sizes, kw = _typed_graph(1, weighted, features=True)
    jg, tg = _pair(rels, sizes, **kw)
    _assert_same_graph(jg, tg)
    assert tg.device == torch.device("cpu")
    ug = ("user", "follows", "user")
    assert tg[ug] is tg.relations[ug]
    assert tg["nothing"] == {}


def test_num_nodes_grow_to_the_largest_index():
    rels = {("a", "to", "b"): ([0, 4], [2, 1])}
    jg, tg = _pair(rels, {"a": 2})
    assert tg.num_nodes == {"a": 5, "b": 3}
    assert int(jg.num_nodes["a"]) == 5 and int(jg.num_nodes["b"]) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("dir", ["in", "out"])
def test_degree_matches_jax(dir, dtype):
    """Each relation's degree on the destination (in) or source (out)
    type's real rows, also at a hub of 300 edges, where a bfloat16 sum of
    ones stops at 256."""
    rels, sizes, _ = _typed_graph(2)
    hub = ("tag", "hub", "user")
    rels[hub] = (np.arange(300) % 5, np.zeros(300, int))
    jg, tg = _pair(rels, sizes)
    for et in tg.etypes:
        got = tg.degree(et, dir=dir, dtype=getattr(torch, dtype))
        want = jg.degree(et, dir=dir, dtype=getattr(jnp, dtype))
        n = sizes[et[2] if dir == "in" else et[0]]
        assert got.shape == (n,) and got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.double().numpy(),
                                      np.asarray(want.astype(
                                          jnp.float64))[:n])
    if dtype == "bfloat16" and dir == "in":
        assert float(tg.degree(hub, dir="in", dtype=torch.bfloat16)[0]) == 256
    with pytest.raises(ValueError, match="dir"):
        tg.degree(hub, dir="both")


def test_edge_type_subgraph_matches_jax():
    rels, sizes, kw = _typed_graph(3, features=True)
    jg, tg = _pair(rels, sizes, **kw)
    for sel in (("user", "rates", "item"),
                [("user", "follows", "user"), ("tag", "on", "item")]):
        _assert_same_graph(jg.edge_type_subgraph(sel),
                           tg.edge_type_subgraph(sel))


@pytest.mark.parametrize("weighted", [False, True])
def test_add_self_loops_hetero_matches_jax(weighted):
    """Self-loops on the user-user relation (weight 1, zero edge features)
    and the same-type check on both sides."""
    rels, sizes, kw = _typed_graph(4, weighted, features=True)
    jg, tg = _pair(rels, sizes, **kw)
    et = ("user", "follows", "user")
    _assert_same_graph(jgnn.add_self_loops_hetero(jg, et),
                       tgnn.add_self_loops_hetero(tg, et))
    for mod, g in ((jgnn, jg), (tgnn, tg)):
        with pytest.raises(ValueError, match="src type == dst type"):
            mod.add_self_loops_hetero(g, ("user", "rates", "item"))


@pytest.mark.parametrize("case", ["old_only", "new_only", "both", "weights",
                                  "new_relation"])
def test_add_edges_hetero_matches_jax(case):
    """New edges on a relation whose features sit on the old edges only,
    on the new edges only, or on both (zero-filled on the side that lacks a
    key), with a weight on one side only, and on a new relation."""
    rng = np.random.default_rng(5)
    sizes = {"user": 7, "item": 11}
    et = ("user", "rates", "item")
    s, r = rng.integers(0, 7, 16), rng.integers(0, 11, 16)
    s2, r2 = rng.integers(0, 7, 5), rng.integers(0, 11, 5)
    old_e = {"e": rng.standard_normal((16, 3))}
    new_e = {"e": rng.standard_normal((5, 3)),
             "f": rng.standard_normal((5, 2))}
    rels = {et: (s, r), ("item", "rated_by", "user"): (r, s)}
    kw, add = {}, {}
    if case in ("old_only", "both"):
        kw["edge_data"] = {et: old_e}
    if case in ("new_only", "both"):
        add["edata"] = new_e
    if case == "weights":
        add["edge_weight"] = rng.random(5) + 0.5
    target = ("item", "similar", "item") if case == "new_relation" else et
    if case == "new_relation":
        s2, r2 = rng.integers(0, 11, 5), rng.integers(0, 11, 5)
        add["edata"] = new_e["e"]          # one array -> "e"
    jg, tg = _pair(rels, sizes, **kw)
    _assert_same_graph(jgnn.add_edges_hetero(jg, target, s2, r2, **add),
                       tgnn.add_edges_hetero(tg, target, s2, r2, **add))
    with pytest.raises(ValueError, match="new edges"):
        tgnn.add_edges_hetero(tg, et, s2, r2, edata={"e": new_e["e"][:3]})


def test_batch_hetero_matches_jax():
    """Three graphs with node and edge features, weights and graph_data:
    per-type offsets, concatenated edges and features."""
    pairs = []
    for seed in (6, 7, 8):
        rels, sizes, kw = _typed_graph(seed, weighted=True, features=True)
        rng = np.random.default_rng(seed)
        sizes = {k: v + seed for k, v in sizes.items()}
        kw["node_data"] = {k: {"x": rng.standard_normal((n, 3))}
                           for k, n in sizes.items()}
        kw["graph_data"] = {"u": rng.standard_normal((1, 4)),
                            "label": np.array([seed])}
        pairs.append(_pair(rels, sizes, **kw))
    jb = jgnn.batch_hetero([p[0] for p in pairs])
    tb = tgnn.batch_hetero([p[1] for p in pairs], device="cpu")
    _assert_same_graph(jb, tb)
    assert tb.graph_data["u"].shape == (3, 4)
    with pytest.raises(ValueError, match="empty"):
        tgnn.batch_hetero([], device="cpu")


def test_to_moves_every_tensor():
    rels, sizes, kw = _typed_graph(9, weighted=True, features=True)
    tg = tgnn.heterograph(rels, num_nodes=sizes, device="cpu", **kw)
    moved = tg.to("meta")
    assert moved.device == torch.device("meta")
    for et in moved.etypes:
        rg = moved.relation_graph(et)
        assert rg.indptr_s.device.type == "meta"
        assert all(v.device.type == "meta" for v in rg.edges.values())
    assert all(v.device.type == "meta" for d in moved.node_data.values()
               for v in d.values())


def test_relation_groupings_are_built_once(monkeypatch):
    """``heterograph()`` groups each relation (on its device, by
    ``graph.group_by``) over ``max(N_src, N_dst)`` nodes; afterwards
    ``relation_graph`` returns that stored graph, and a HeteroGraphConv
    forward and backward sort and group nothing."""
    rels, sizes, _ = _typed_graph(10)
    calls = []
    group_by = TG.group_by
    monkeypatch.setattr(TG, "group_by",
                        lambda *a: calls.append(1) or group_by(*a))
    tg = tgnn.heterograph(rels, num_nodes=sizes, device="cpu")
    # per relation: receivers, then senders, then the one graph's nodes
    assert len(calls) == 3 * len(rels)
    for et in tg.etypes:
        rg = tg.relation_graph(et)
        assert rg is tg.relation_graph(et)
        assert rg.num_nodes == max(sizes[et[0]], sizes[et[2]])
    conv = TM.HeteroGraphConv({et: TM.SAGEConv(3, 2, **KW)
                               for et in tg.etypes})

    def refuse(*a, **k):
        raise AssertionError("sorted on a forward")

    monkeypatch.setattr(TG, "group_by", refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    x = {nt: torch.randn(n, 3, dtype=torch.float64, requires_grad=True)
         for nt, n in sizes.items()}
    out = conv(tg, x)
    sum(v.sum() for v in out.values()).backward()
    assert x["tag"].grad is not None


# ---- HeteroGraphConv -------------------------------------------------------

def _layer_pair(kind, din, dout, seed):
    """A JAX layer (float64) and the port's with its parameters."""
    r = nnx.Rngs(seed)
    if kind == "sage":
        j, p = JM.SAGEConv(din, dout, rngs=r), TM.SAGEConv(din, dout, **KW)
    elif kind == "graphconv":
        j, p = (JM.GraphConv(din, dout, jax.nn.relu, rngs=r),
                TM.GraphConv(din, dout, torch.relu, **KW))
    elif kind == "gcn":
        j, p = JM.GCNConv(din, dout, rngs=r), TM.GCNConv(din, dout, **KW)
    elif kind == "gat":
        j = JM.GATConv(din, dout, heads=2, add_self_loops=False, rngs=r)
        p = TM.GATConv(din, dout, heads=2, add_self_loops=False, **KW)
    elif kind == "gatv2":
        j = JM.GATv2Conv(din, dout, heads=2, add_self_loops=False, rngs=r)
        p = TM.GATv2Conv(din, dout, heads=2, add_self_loops=False, **KW)
    return j, p


def _hetero_case(layers, sizes, counts, din, seed, aggr="sum"):
    """Both packages' HeteroGraphConv over one relation set, the same
    parameters; the graphs and inputs."""
    rng = np.random.default_rng(seed)
    rels = _relations(rng, sizes, counts)
    jg, tg = _pair(rels, sizes)
    pairs = [_layer_pair(kind, din, 4, seed + i)
             for i, kind in enumerate(layers)]
    jm = jax_params_f64(JM.HeteroGraphConv(
        {et: j for et, (j, _) in zip(counts, pairs)}, aggr=aggr))
    tm = port_from_jax(TM.HeteroGraphConv(
        {et: p for et, (_, p) in zip(counts, pairs)}, aggr=aggr), jm)
    x = {nt: rng.standard_normal((n, din)) for nt, n in sizes.items()}
    return jg, tg, jm, tm, x, rng


def _compare_hetero(jg, tg, jm, tm, x, rng):
    """Forward and the gradients of ``sum_t sum(out_t * cot_t)`` with
    respect to every input and every parameter."""
    sizes = tg.num_nodes
    out_t = tm(tg, {nt: t(v) for nt, v in x.items()})
    cot = {nt: rng.standard_normal(tuple(v.shape)) for nt, v in out_t.items()}
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, xx, g):
        out = nnx.merge(gd, p, rest)(g, xx)
        return sum(jnp.sum(out[nt][: sizes[nt]] * c)
                   for nt, c in cot.items()), out

    jx = {nt: jnp.asarray(pad_rows(v, jg.n_pad(nt))) for nt, v in x.items()}
    # one compiled program: JAX's eager ops would compile one by one
    (_, jout), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jx, jg)
    tx = {nt: t(v, grad=True) for nt, v in x.items()}
    tm.zero_grad()
    out = tm(tg, tx)
    assert set(out) == set(jout)
    sum((out[nt] * t(c)).sum() for nt, c in cot.items()).backward()
    for nt in out:
        np.testing.assert_allclose(out[nt].detach().numpy(),
                                   np.asarray(jout[nt])[: sizes[nt]],
                                   err_msg=f"out[{nt}]", **F64_TOL)
    for nt in x:
        want = np.asarray(gx[nt])[: sizes[nt]]
        got = (tx[nt].grad.numpy() if tx[nt].grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, err_msg=f"dx[{nt}]",
                                   **F64_TOL)
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(gp)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 ref.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.detach().numpy(),
                                   err_msg=name, **F64_TOL)


# "big" has more nodes than "small": rel0 runs big -> small (N_src > N_dst),
# rel1 small -> big, rel2 big -> big and rel3 big -> small again, so each
# destination type merges two relations
_COUNTS = {("big", "r0", "small"): 40, ("small", "r1", "big"): 35,
           ("big", "r2", "big"): 30, ("big", "r3", "small"): 20}


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("sizes", [{"big": 17, "small": 6},
                                   {"big": 9, "small": 8}],
                         ids=["far", "near"])
def test_hetero_conv_matches_jax(aggr, sizes):
    """SAGE, GraphConv, GCN (its bipartite form: source and destination
    degrees apart, no self term) and SAGE again, merged per destination
    type by ``aggr``: forward and every gradient against JAX."""
    jg, tg, jm, tm, x, rng = _hetero_case(
        ["sage", "graphconv", "gcn", "sage"], sizes, _COUNTS, 3,
        seed=20, aggr=aggr)
    _compare_hetero(jg, tg, jm, tm, x, rng)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_hetero_attention_matches_jax(monkeypatch, route, kind):
    """GATConv and GATv2Conv (two heads, no self-loops: JAX's docstring,
    heteroconv.py:30) on relations between types of unequal sizes, both
    ways: the plain path, and the kernels' autograd functions (their plain
    versions on CPU tensors) with the receiver CSR cut to the destination
    rows and the sender CSR to the source rows."""
    if route == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    counts = {("big", "r0", "small"): 40, ("small", "r1", "big"): 35}
    jg, tg, jm, tm, x, rng = _hetero_case(
        [kind, kind], {"big": 15, "small": 6}, counts, 3, seed=30)
    _compare_hetero(jg, tg, jm, tm, x, rng)


def test_hetero_conv_unknown_aggr_raises():
    jg, tg, jm, tm, x, _ = _hetero_case(["sage", "sage"],
                                        {"big": 5, "small": 4},
                                        {("big", "a", "small"): 6,
                                         ("small", "b", "small"): 6}, 2, 40,
                                        aggr="median")
    for m, g in ((jm, jg), (tm, tg)):
        with pytest.raises(ValueError, match="unknown aggr"):
            m(g, {nt: (t(v) if m is tm else jnp.asarray(v))
                  for nt, v in x.items()})


def _example():
    spec = importlib.util.spec_from_file_location(
        "hetero_recommendation",
        os.path.join(ROOT, "examples", "hetero_recommendation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _PortModel(torch.nn.Module):
    """examples/hetero_recommendation.py's two-layer model in the port."""

    def __init__(self, din, nh):
        super().__init__()
        rel = (("user", "rates", "movie"), ("movie", "rated_by", "user"))
        self.conv1 = TM.HeteroGraphConv({
            et: TM.SAGEConv(din, nh, torch.relu, **KW) for et in rel})
        self.conv2 = TM.HeteroGraphConv({
            et: TM.SAGEConv(nh, nh, **KW) for et in rel})

    def forward(self, g, uu, mm):
        x = {nt: g.node_data[nt]["x"] for nt in ("user", "movie")}
        h = self.conv2(g, self.conv1(g, x))
        return (h["user"][uu] * h["movie"][mm]).sum(-1)


def test_hetero_recommendation_adam_steps_match_jax():
    """Three Adam steps (lr 5e-3) of the example's model at its own sizes
    (200 users, 120 movies, 2,400 rated pairs each way, widths 8 and 32):
    each step's MSE loss and the final parameters against JAX's."""
    ex = _example()
    jg, (u, m, rating, split) = ex.make_data()
    nd = {nt: {"x": np.asarray(jg.node_data[nt]["x"], np.float64)[
        : int(jg.num_nodes[nt])]} for nt in ("user", "movie")}
    rels = {et: (np.asarray(rel.senders)[: int(rel.num_edges)],
                 np.asarray(rel.receivers)[: int(rel.num_edges)])
            for et, rel in jg.relations.items()}
    jg = jgnn.heterograph(rels, num_nodes={k: int(v) for k, v in
                                           jg.num_nodes.items()},
                          node_data=nd)
    tg = tgnn.heterograph(rels, num_nodes=jg.num_nodes, node_data=nd,
                          device="cpu")
    jm = jax_params_f64(ex.Model(8, 32, nnx.Rngs(0)))
    tm = port_from_jax(_PortModel(8, 32), jm)
    state = JT.TrainState(jm, optax.adam(5e-3))

    def jloss(mod, g, uu, mm, rr):
        return jnp.mean((mod(g, uu, mm) - rr) ** 2)

    def tloss(mod, g, uu, mm, rr):
        return ((mod(g, uu, mm) - rr) ** 2).mean()

    jstep = JT.make_train_step(state, jloss)
    tstep = TT.make_train_step(tm, torch.optim.Adam(tm.parameters(), 5e-3),
                               tloss)
    uu, mm, rr = u[:split], m[:split], rating[:split].astype(np.float64)
    params, opt_state = state.params, state.opt_state
    for _ in range(3):
        params, opt_state, jl = jstep(params, opt_state, jg, jnp.asarray(uu),
                                      jnp.asarray(mm), jnp.asarray(rr))
        tl = tstep(tg, torch.as_tensor(uu), torch.as_tensor(mm), t(rr))
        np.testing.assert_allclose(float(tl), float(jl), **F64_TOL)
    want = load_jax_params(copy.deepcopy(tm), pure_params(state.model(params)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=name, **F64_TOL)
