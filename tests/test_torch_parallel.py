"""The port's multi-device path (``parallel/``) against the JAX package's.

The JAX side runs here, on the 8-device CPU mesh of ``tests/conftest.py``
and on one device, in float64; the port's runs in 4 ranks spawned once for
the whole file (``torch.multiprocessing.spawn``, gloo, float64 on the CPU:
``torch_parallel_workers.run_cases``), fed the same numpy graphs, inputs
and JAX-initialised parameters. Checked:

- ``partition_nodes`` equals JAX's bit for bit; ``partition_graph``'s owned
  sets, cut statistics, halo row sets and each edge's sender and weight
  (combined and split, and on the reversed partition) equal JAX's;
- the sharded propagate, combined and split, weighted and not, forward and
  the gradient in ``x``, equals JAX's single-device ``propagate`` and JAX's
  ``make_sharded_propagate`` on the 8-device mesh;
- ``make_sharded_apply`` over GCNConv (with and without the graph's
  weights), SAGEConv, GATConv (also by the card's autograd functions on
  CPU tensors), GraphConv(max) and DConv on the reversed partition
  (weighted and not): forward and the gradients in ``x`` and in every
  parameter equal JAX's single-device ones;
- a part whose halo buffer would have as many rows as it owns nodes gets
  one padding row, and propagate and GraphConv(max) (whose ops convert the
  operand twice) still equal JAX;
- ``make_mesh_train_step`` on a (data 2 x graph 2) mesh (SGD: the step is
  linear in the gradient) and on a 4-part graph mesh (3 Adam steps of the
  dryrun's GCN -> GAT -> Linear chain) equals JAX training the same model on
  one device over the same graphs;
- a view without the reversed partition refuses ``reverse()`` and the
  out-degree; the out-degree on one with it equals the single-device one.

Tolerance: float64 against float64, summation order only (rtol 1e-9, atol
1e-10, ``F64_TOL``). The JAX sides run under ``jax.jit``.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu import ops as JO  # noqa: E402
from graphneuralnetworks_tpu import parallel as JP  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch import parallel as TP  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa
from torch_parity import (F64_TOL, jax_params_f64, pad_rows,  # noqa: E402
                          pure_params)
import torch_parallel_workers as W  # noqa: E402

RANKS = 4
JAX_DEVICES = 8


def _directed(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e), n,
            rng.random(e) + 0.5)


def _bidirected(seed, n, pairs):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    return (np.concatenate([a, b]), np.concatenate([b, a]), n,
            rng.random(2 * pairs) + 0.5)


def _collision(n_parts=RANKS, per=4):
    """Range parts of ``per`` nodes; part ``p``'s nodes receive from the
    ``per`` nodes of part ``p + 1`` only (two edges each), so its halo
    buffer has exactly as many rows as it owns nodes."""
    n = n_parts * per
    r = np.repeat(np.arange(n), 2)
    p, i = r // per, r % per
    nxt = ((p + 1) % n_parts) * per
    s = nxt + np.where(np.arange(2 * n) % 2 == 0, i, (i + 1) % per)
    return s, r, n, None


G_DIR = _directed(1, 96, 512)
G_BI = _bidirected(7, 96, 256)
G_DCONV = _directed(9, 64, 256)
G_COLL = _collision()
PARTS_RANDOM = np.random.default_rng(7).integers(0, RANKS, 96)
X16 = {n: np.random.default_rng(2).standard_normal((n, 16))
       for n in (16, 64, 96)}
T16 = np.random.default_rng(13).standard_normal((96, 16))

PROPAGATE = {f"{'split' if split else 'combined'}_"
             f"{'weighted' if w else 'unweighted'}": (split, w)
             for split in (False, True) for w in (False, True)}

# name: (JAX layer, graph, partitioned with the reverse)
LAYERS = {
    "gcn": (lambda r: JM.GCNConv(16, 8, jax.nn.relu, rngs=r), G_BI, False),
    "gcn_w": (lambda r: JM.GCNConv(16, 8, use_edge_weight=True, rngs=r),
              G_BI, False),
    "sage": (lambda r: JM.SAGEConv(16, 8, rngs=r), G_BI, False),
    "gat": (lambda r: JM.GATConv(16, 4, heads=2, rngs=r), G_BI, False),
    "gat_kernels": (lambda r: JM.GATConv(16, 4, heads=2, rngs=r), G_BI,
                    False),
    "graphconv_max": (lambda r: JM.GraphConv(16, 8, aggr="max", rngs=r),
                      G_BI, False),
    "dconv": (lambda r: JM.DConv(16, 8, k=3, rngs=r),
              G_DCONV[:3] + (None,), True),
    "dconv_w": (lambda r: JM.DConv(16, 8, k=3, rngs=r), G_DCONV, True),
}


def _jax_graph(arrays):
    s, r, n, w = arrays
    return jgnn.graph(s, r, num_nodes=n, edge_weight=w)


def _jax_layer(name):
    return jax_params_f64(LAYERS[name][0](nnx.Rngs(0)))


def _train_data(seed, n, din=6, nout=3):
    rng = np.random.default_rng(seed)
    return (_directed(seed, n, 4 * n)[:3] + (None,),
            rng.standard_normal((n, din)), rng.integers(0, nout, n))


TRAIN = {
    # (data x graph) 2 x 2, one SGD step (the JAX test's chain and optimizer)
    "train_2x2": dict(mesh=((2, 2), ("data", "graph")),
                      data=[_train_data(10, 48), _train_data(11, 48)],
                      model="chain_gcn_sage", opt="sgd", lr=0.1, steps=2),
    # a graph mesh of 4 parts, 3 Adam steps of the dryrun's chain
    "train_graph4": dict(mesh=((RANKS,), ("graph",)),
                         data=[_train_data(12, 64)],
                         model="chain_gcn_gat", opt="adam", lr=1e-2,
                         steps=3),
}


def _jax_model(name):
    r = nnx.Rngs(0)
    if name == "chain_gcn_sage":
        m = JM.GNNChain(JM.GCNConv(6, 8, jax.nn.relu, rngs=r),
                        JM.SAGEConv(8, 3, rngs=r))
    else:
        m = JM.GNNChain(JM.GCNConv(6, 8, jax.nn.relu, rngs=r),
                        JM.GATConv(8, 8, heads=2, concat=False, rngs=r),
                        nnx.Linear(8, 3, rngs=r))
    return jax_params_f64(m)


def _cases():
    cases = {}
    for name, (split, w) in PROPAGATE.items():
        s, r, n, ew = G_DIR
        cases[f"prop_{name}"] = dict(kind="propagate",
                                     graph=(s, r, n, ew if w else None),
                                     x=X16[96], t=T16, parts=PARTS_RANDOM,
                                     split=split)
    cases["prop_collision"] = dict(kind="propagate", graph=G_COLL, x=X16[16],
                                   t=T16[:16], parts=None, split=False)
    for name, (_, graph, rev) in LAYERS.items():
        cases[name] = dict(kind="layer", layer=name, graph=graph,
                           x=X16[graph[2]], with_reverse=rev,
                           params=pure_params(_jax_layer(name)))
    cases["graphconv_max_collision"] = dict(
        kind="layer", layer="graphconv_max", graph=G_COLL, x=X16[16],
        params=pure_params(_jax_layer("graphconv_max")))
    for name, c in TRAIN.items():
        gp = c["mesh"][0][-1]
        cases[name] = dict(
            kind="train", mesh=c["mesh"], model=c["model"], opt=c["opt"],
            lr=c["lr"], steps=c["steps"],
            graphs=[d[0] for d in c["data"]],
            parts=[TP.partition_nodes(d[0][0], d[0][1], d[0][2], gp)
                   for d in c["data"]],
            xs=[d[1] for d in c["data"]], ys=[d[2] for d in c["data"]],
            params=pure_params(_jax_model(c["model"])))
    cases["raises"] = dict(kind="raises", graph=G_DIR)
    return cases


@pytest.fixture(scope="module")
def port():
    """Every case of :func:`_cases` on 4 gloo ranks: ``{case: [rank
    results]}``."""
    ranks = W.spawn(W.run_cases, RANKS, _cases())
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def _gather(results, key, n):
    first = np.asarray(results[0][key])
    out = np.zeros((n,) + first.shape[1:])
    for res in results:
        out[res["owned"]] = np.asarray(res[key])
    return out


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:JAX_DEVICES]), ("graph",))


# ---- partitioning ----------------------------------------------------------

def _sbm(n=4096, e=40000, ncomm=16, seed=0):
    rng = np.random.default_rng(seed)
    comm = rng.permutation(n) % ncomm
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    intra = rng.random(e) < 0.8
    for c in range(ncomm):
        m = intra & (comm[s] == c)
        if m.any():
            r[m] = rng.choice(np.nonzero(comm == c)[0], int(m.sum()))
    return s, r, n


@pytest.mark.parametrize("num_parts,seed,balance", [
    (2, 0, 1.05), (4, 0, 1.05), (8, 0, 1.05), (4, 3, 1.2), (3, 1, 1.0)])
def test_partition_nodes_matches_jax(num_parts, seed, balance):
    s, r, n = _sbm(seed=seed)
    kw = dict(balance=balance, seed=seed)
    want = JP.partition_nodes(s, r, n, num_parts, **kw)
    got = TP.partition_nodes(s, r, n, num_parts, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _check_partition(jpg, tpg, split):
    P = tpg.num_parts
    ng, nm = np.asarray(jpg.node_global), np.asarray(jpg.node_mask)
    np.testing.assert_array_equal(np.asarray(jpg.cut_stats), tpg.cut_stats)
    assert tpg.cut_fraction == pytest.approx(jpg.cut_fraction, abs=0)
    assert tpg.halo_bytes_per_step(16) == jpg.halo_bytes_per_step(16)
    hs = np.asarray(jpg.halo_send)
    for p in range(P):
        np.testing.assert_array_equal(tpg.owned[p], ng[p][nm[p]])
        for q in range(P):
            k = len(tpg.halo[q][p])
            np.testing.assert_array_equal(tpg.halo[q][p], hs[q, p, :k])
            assert not hs[q, p, k:].any()
        em = np.asarray(jpg.edge_mask)[p]
        np.testing.assert_array_equal(tpg.recv_local[p],
                                      np.asarray(jpg.recv_local)[p][em])
        # each edge's global sender, through either package's buffer
        sb = np.asarray(jpg.send_halo_idx)[p][em]
        want = ng[sb // jpg.h_max, hs[sb // jpg.h_max, p, sb % jpg.h_max]]
        bounds = np.cumsum([0] + [len(tpg.halo[q][p]) for q in range(P)])
        blk = np.searchsorted(bounds, tpg.send_buf[p], side="right") - 1
        loc = np.array([tpg.halo[q][p][i - bounds[q]]
                        for q, i in zip(blk, tpg.send_buf[p])], np.int64)
        got = np.array([tpg.owned[q][v] for q, v in zip(blk, loc)],
                       np.int64).reshape(-1)
        np.testing.assert_array_equal(got, want)
        if tpg.edge_weight is not None:
            np.testing.assert_array_equal(tpg.edge_weight[p],
                                          np.asarray(jpg.edge_weight)[p][em])
        if not split:
            continue
        om, rm = np.asarray(jpg.own_mask)[p], np.asarray(jpg.rem_mask)[p]
        np.testing.assert_array_equal(tpg.own_recv[p],
                                      np.asarray(jpg.own_recv)[p][om])
        np.testing.assert_array_equal(tpg.own_send[p],
                                      np.asarray(jpg.own_send)[p][om])
        np.testing.assert_array_equal(tpg.rem_recv[p],
                                      np.asarray(jpg.rem_recv)[p][rm])
        hr = np.asarray(jpg.halo_send_rem)
        rs = np.asarray(jpg.rem_send)[p][rm]
        want = ng[rs // jpg.h_rem, hr[rs // jpg.h_rem, p, rs % jpg.h_rem]]
        others = [q for q in range(P) if q != p]
        rb = np.cumsum([0] + [len(tpg.halo[q][p]) for q in others])
        k = np.searchsorted(rb, tpg.rem_send[p], side="right") - 1
        got = np.array([tpg.owned[others[j]][tpg.halo[others[j]][p][i - rb[j]]]
                        for j, i in zip(k, tpg.rem_send[p])], np.int64)
        np.testing.assert_array_equal(got.reshape(-1), want)


@pytest.mark.parametrize("parts", ["range", "bfs", "random"])
@pytest.mark.parametrize("with_reverse", [False, True])
def test_partition_graph_matches_jax(parts, with_reverse):
    s, r, n, w = G_DIR
    jg = jgnn.graph(s, r, num_nodes=n, edge_weight=w)
    tg = tgnn.graph(s, r, num_nodes=n, edge_weight=w, device="cpu")
    assignment = {"range": None, "bfs": "bfs", "random": PARTS_RANDOM}[parts]
    jpg = JP.partition_graph(jg, RANKS, parts=assignment,
                             with_reverse=with_reverse)
    tpg = TP.partition_graph(tg, RANKS, parts=assignment,
                             with_reverse=with_reverse)
    _check_partition(jpg, tpg, split=True)
    assert (tpg.reverse_pg is None) == (not with_reverse)
    if with_reverse:
        _check_partition(jpg.reverse_pg, tpg.reverse_pg, split=True)


def test_partition_graph_without_split_and_roundtrip():
    s, r, n, w = G_DIR
    tg = tgnn.graph(s, r, num_nodes=n, edge_weight=w, device="cpu")
    tpg = TP.partition_graph(tg, RANKS, split_local=False)
    assert not tpg.split_local and tpg.own_recv is None
    x = np.random.default_rng(0).standard_normal((n, 3))
    parts = tpg.scatter_nodes(x)
    assert [len(a) for a in parts] == [len(o) for o in tpg.owned]
    np.testing.assert_array_equal(tpg.gather_nodes(parts), x)
    xt = torch.as_tensor(x)
    back = tpg.gather_nodes(tpg.scatter_nodes(xt))
    assert isinstance(back, torch.Tensor)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="parts must be"):
        TP.partition_graph(tg, RANKS, parts=np.full(n, RANKS))
    with pytest.raises(ValueError, match="reversed"):
        TP.partition_graph(tg.reverse(), RANKS)


# ---- the sharded propagate -------------------------------------------------

@pytest.mark.parametrize("name", list(PROPAGATE))
def test_sharded_propagate_matches_jax(port, jax_mesh, name):
    split, weighted = PROPAGATE[name]
    s, r, n, w = G_DIR
    jg = _jax_graph((s, r, n, w if weighted else None))
    f = JO.w_mul_xj if weighted else JO.copy_xj
    t_pad = jnp.asarray(pad_rows(T16, jg.n_pad))

    def loss(xx):
        y = JO.propagate(f, jg, "sum", xj=xx)
        return jnp.sum(y * t_pad), y

    (_, y1), gx1 = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(pad_rows(X16[96], jg.n_pad)))
    # JAX's own sharded path on the 8-device mesh, the same split choice
    jpg = JP.partition_graph(jg, JAX_DEVICES)
    if not split:
        jpg = dataclasses.replace(
            jpg, own_recv=None, own_send=None, own_mask=None,
            own_weight=None, rem_recv=None, rem_send=None, rem_mask=None,
            rem_weight=None, halo_send_rem=None, split_aux=None)
    run = JP.make_sharded_propagate(jax_mesh, jpg)
    xs, ts = jpg.scatter_nodes(X16[96]), jpg.scatter_nodes(T16)
    y8 = jpg.gather_nodes(run(xs, jpg))
    gx8 = jpg.gather_nodes(jax.grad(lambda v: jnp.sum(run(v, jpg) * ts))(xs))

    res = port[f"prop_{name}"]
    y, gx = _gather(res, "y", n), _gather(res, "gx", n)
    for ref_y, ref_gx in ((np.asarray(y1)[:n], np.asarray(gx1)[:n]),
                          (y8, gx8)):
        np.testing.assert_allclose(y, ref_y, **F64_TOL)
        np.testing.assert_allclose(gx, ref_gx, **F64_TOL)
    assert [r_["num_nodes"] for r_ in res] == [
        int((PARTS_RANDOM == p).sum()) for p in range(RANKS)]
    # the propagate's view holds the owned/remote split where the
    # partition has one; the layers' views never build it
    assert [r_["has_split"] for r_ in res] == [split] * RANKS


def test_buffer_row_collision_gets_a_padding_row(port):
    """Every part's buffer would hold as many rows as it owns nodes (4):
    each gets one zero row more, and the results still equal JAX's."""
    s, r, n, _ = G_COLL
    for name in ("prop_collision", "graphconv_max_collision"):
        res = port[name]
        assert [(v["num_nodes"], v["src_rows"]) for v in res] == \
            [(4, 5)] * RANKS, name
    jg = _jax_graph(G_COLL)
    xg = jnp.asarray(pad_rows(X16[16], jg.n_pad))
    y_ref, vjp = jax.vjp(lambda v: JO.propagate(JO.copy_xj, jg, "sum", xj=v),
                         xg)
    gx_ref = vjp(jnp.asarray(pad_rows(T16[:16], jg.n_pad)))[0]
    res = port["prop_collision"]
    np.testing.assert_allclose(_gather(res, "y", n), np.asarray(y_ref)[:n],
                               **F64_TOL)
    np.testing.assert_allclose(_gather(res, "gx", n), np.asarray(gx_ref)[:n],
                               **F64_TOL)
    _check_layer(port["graphconv_max_collision"], "graphconv_max", G_COLL)


# ---- layers on the parts' views ---------------------------------------------

def _check_layer(res, name, graph):
    jm = _jax_layer(name)
    n = graph[2]
    jg = _jax_graph(graph)
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss(p, xx):
        y = nnx.merge(gd, p, rest)(jg, xx)[:n]
        return jnp.sum(y ** 2), y

    (_, y_ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(pad_rows(X16[n], jg.n_pad)))
    np.testing.assert_allclose(_gather(res, "y", n), np.asarray(y_ref),
                               **F64_TOL)
    np.testing.assert_allclose(_gather(res, "gx", n), np.asarray(gx)[:n],
                               **F64_TOL)
    assert not any(r_["has_split"] for r_ in res)   # built only to propagate
    ref = load_jax_params(W._layer(name),
                          jax.tree.map(np.asarray, nnx.to_pure_dict(gp)))
    for rank_res in res:     # summed over the ranks: the same on every one
        for k, p in ref.named_parameters():
            np.testing.assert_allclose(rank_res["grads"][k].numpy(),
                                       p.detach().numpy(), err_msg=k,
                                       **F64_TOL)


@pytest.mark.parametrize("name", list(LAYERS))
def test_sharded_layer_matches_jax(port, name):
    _check_layer(port[name], name, LAYERS[name][1])


# ---- training -----------------------------------------------------------------

def _jax_train(name):
    """JAX training the same model on one device over the same graphs:
    losses and parameters after the first and the last step."""
    c = TRAIN[name]
    model = _jax_model(c["model"])
    gd, params = nnx.split(model)
    tx = optax.sgd(c["lr"]) if c["opt"] == "sgd" else optax.adam(c["lr"])
    state = tx.init(params)
    data = [(_jax_graph(g), x, y) for g, x, y in c["data"]]

    def loss(p):
        m = nnx.merge(gd, p)
        tot = cnt = 0.0
        for jg, x, y in data:
            n = int(jg.num_nodes)
            logits = m(jg, jnp.asarray(pad_rows(x, jg.n_pad)))[:n]
            ls = jax.nn.log_softmax(logits)
            tot = tot + -jnp.sum(jnp.take_along_axis(
                ls, jnp.asarray(y)[:, None], axis=-1))
            cnt = cnt + n
        return tot / cnt

    losses, after = [], []
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    for _ in range(c["steps"]):
        val, grads = value_and_grad(params)
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(val))
        after.append(jax.tree.map(np.asarray, nnx.to_pure_dict(
            nnx.state(nnx.merge(gd, params), nnx.Param))))
    return losses, after[0], after[-1]


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_step_matches_jax(port, name):
    losses, first, last = _jax_train(name)
    model = TRAIN[name]["model"]
    for res in port[name]:
        np.testing.assert_allclose(res["losses"], losses, **F64_TOL)
        assert res["losses"][-1] < res["losses"][0]
        for key, ref in (("first", first), ("last", last)):
            want = load_jax_params(W._layer(model), ref)
            for k, p in want.named_parameters():
                np.testing.assert_allclose(res[key][k].numpy(),
                                           p.detach().numpy(),
                                           err_msg=f"{key} {k}", **F64_TOL)


def test_reverse_and_out_degree_on_a_view(port):
    res = port["raises"]
    for v in res:
        assert "with_reverse=True" in v["reverse"]
        assert "with_reverse=True" in v["out_degree"]
        assert "explicit edge weights" in v["out_degree_weights"]
    s, r, n, w = G_DIR
    jg = _jax_graph(G_DIR)
    for direction in ("out", "both"):
        want = np.asarray(jgnn.degree(jg, dir=direction,
                                      dtype=jnp.float64))[:n]
        np.testing.assert_allclose(_gather(res, f"degree_{direction}", n),
                                   want, **F64_TOL)
