"""The port's DeviceSampler and edge validity against the JAX package's.

- Structure: the slot senders and receivers, the block sizes and the block
  edge prefixes equal JAX's real entries; each block's groupings, built
  with no sort, equal ``graph()``'s for the same edges.
- The draw's semantics on the port's own ``torch.Generator`` (JAX's
  ``jax.random`` bits cannot be reproduced), as
  ``tests/test_device_sampler.py`` holds JAX's: sampled edges exist, a
  frontier with no in-edges is masked and echoes its parent, draws without
  replacement are distinct and complete with uniform marginals, and
  ``build``'s errors are JAX's.
- Numerics with JAX's draw fed to the port: ``nid`` and ``edge_valid`` from
  JAX's ``sample`` / ``sample_blocks`` (x64, CPU, no SpMM aux) through
  ``graph_of`` / ``blocks_of``; the two-layer SAGE logits and every
  gradient match JAX at F64_TOL, with and without replacement (the latter
  with invalid edges), on the full slot graph and on the blocks.
- Edge validity: sum and mean ``propagate`` honour it (a numpy oracle, and
  JAX on one draw); each route family that does not honour it raises.
- A training smoke run: the loss falls, as JAX's ``test_sage_train_step_smoke``.
- ``gpu``-marked (they skip without a card; this file imports JAX only in
  the tests that need it, so on a machine with a card and no JAX they run
  with ``python -m pytest tests/test_torch_device_sampler.py --noconftest
  -o addopts="" -m gpu``): K1 at D = 100 and 256 on the block CSRs of a
  (1024, (15, 10)) draw against ``spmm_plain``, ``device_graph`` on the
  card against the CPU, and the draw's semantics on the card.
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as TO  # noqa: E402
from graphneuralnetworks_tpu_torch.device_sampler import (  # noqa: E402
    DeviceSampler)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


@pytest.fixture(scope="module")
def J():
    """The JAX package's pieces, imported here so that the card tests of
    this file run where JAX is not installed."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import graphneuralnetworks_tpu as jgnn
    from graphneuralnetworks_tpu import models as JM
    from graphneuralnetworks_tpu import ops as JO
    from graphneuralnetworks_tpu.device_sampler import (DeviceSampler as JDS,
                                                        apply_blocks)
    import torch_parity
    return SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, gnn=jgnn, M=JM, ops=JO,
                           DS=JDS, apply_blocks=apply_blocks, P=torch_parity)


def _csr_of(s, r, n):
    """In-edge CSR (senders grouped by receiver), numpy."""
    order = np.argsort(r, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return s[order].astype(np.int32), ptr.astype(np.int64)


def _rand_csr(n, e, seed, isolated=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n - isolated, e)
    cs, ptr = _csr_of(s, r, n)
    return cs, ptr, s, r


def _skewed_csr(n=60, seed=5):
    """Degrees 0 to 25: nodes 0-4 receive nothing, the rest fewer or more
    in-edges than a fanout of 4, so draws without replacement leave invalid
    slots. A node's in-neighbors are distinct: distinct draws (CSR
    positions) are distinct node ids."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([np.zeros(5, int), rng.integers(1, 26, n - 5)])
    r = np.repeat(np.arange(n), deg)
    s = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    cs, ptr = _csr_of(s, r, n)
    return cs, ptr, s, r


def test_structure_constants(J):
    bs, fanouts = 4, (3, 2)
    cs, ptr, _, _ = _rand_csr(30, 200, 0)
    jsp = J.DS.build(cs, ptr, fanouts=fanouts, batch_size=bs,
                     build_spmm_aux=False)
    tsp = DeviceSampler.build(cs, ptr, fanouts=fanouts, batch_size=bs,
                              device="cpu")
    assert (tsp.n_slots, tsp.e_total) == (jsp.n_slots, jsp.e_total) == \
        (4 + 12 + 24, 12 + 24)
    e = tsp.e_total
    np.testing.assert_array_equal(tsp.senders.numpy(),
                                  np.asarray(jsp.senders)[:e])
    np.testing.assert_array_equal(tsp.receivers.numpy(),
                                  np.asarray(jsp.receivers)[:e])
    assert tsp.block_sizes == jsp.block_sizes
    for tb, jb in zip(tsp.blocks, jsp.block_templates):
        ne = tb.num_edges
        np.testing.assert_array_equal(tb.senders.numpy(),
                                      np.asarray(jb.senders)[:ne])
        np.testing.assert_array_equal(tb.receivers.numpy(),
                                      np.asarray(jb.receivers)[:ne])
    assert torch.equal(tsp.lo_deg, torch.tensor(
        np.stack([ptr[:-1], np.diff(ptr)], 1), dtype=torch.int32))


def test_block_groupings_equal_graph():
    cs, ptr, _, _ = _rand_csr(40, 300, 1)
    sp = DeviceSampler.build(cs, ptr, fanouts=(3, 2, 2), batch_size=5,
                             device="cpu")
    assert sp.graph is sp.blocks[0]
    for b in sp.blocks:
        want = tgnn.graph(b.senders, b.receivers, num_nodes=b.num_nodes,
                          device="cpu")
        for f in ("senders", "receivers", "indptr_r", "col_r", "indptr_s",
                  "col_s", "node_graph_id", "indptr_g", "indptr_ge"):
            assert torch.equal(getattr(b, f), getattr(want, f)), f
        # senders ascend: the sender grouping's positions are the edge ids
        assert b.eid_s is None
        assert torch.equal(want.eid_s, torch.arange(b.num_edges,
                                                    dtype=torch.int32))


@pytest.mark.parametrize("device", DEVICES)
def test_sampled_edges_exist_in_graph(device):
    dev = _device(device)
    cs, ptr, s, r = _rand_csr(50, 600, 1)
    sp = DeviceSampler.build(cs, ptr, fanouts=(4, 3), batch_size=8,
                             device=dev)
    seeds = torch.tensor([0, 3, 7, 11, 20, 33, 41, 49], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gb = sp.sample(gen, seeds)
    nid = gb.nodes["NID"].cpu().numpy()
    assert nid.dtype == np.int32 and nid.shape == (sp.n_slots,)
    np.testing.assert_array_equal(nid[:8], seeds.cpu().numpy())
    ev = gb.edge_valid.cpu().numpy()
    assert ev.all()   # every node of this graph has in-edges
    has_edge = set(zip(s.tolist(), r.tolist()))
    gs, gr = gb.senders.cpu().numpy(), gb.receivers.cpu().numpy()
    for a, b in zip(nid[gs[ev]].tolist(), nid[gr[ev]].tolist()):
        assert (a, b) in has_edge
    assert nid.min() >= 0 and nid.max() < 50


@pytest.mark.parametrize("device", DEVICES)
def test_zero_degree_masks_and_echoes(device):
    dev = _device(device)
    # node 5 has no in-edges: the edges drawn below it are invalid and its
    # child slots echo its id
    s = np.array([0, 1, 2, 3, 4, 0, 1])
    r = np.array([1, 2, 3, 4, 0, 2, 3])
    cs, ptr = _csr_of(s, r, 6)
    sp = DeviceSampler.build(cs, ptr, fanouts=(2, 2), batch_size=2,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gb = sp.sample(gen, torch.tensor([5, 1], device=dev))
    ev = gb.edge_valid.cpu().numpy()
    nid = gb.nodes["NID"].cpu().numpy()
    assert not ev[0] and not ev[1] and ev[2] and ev[3]
    assert nid[2] == 5 and nid[3] == 5
    assert not ev[4:8].any()   # the mask propagates a layer down
    assert torch.equal(gb.edge_mask, gb.edge_valid)


@pytest.mark.parametrize("device", DEVICES)
def test_without_replacement_distinct_and_complete(device):
    dev = _device(device)
    cs, ptr, _, _ = _skewed_csr()
    k = 5
    sp = DeviceSampler.build(cs, ptr, fanouts=(k,), batch_size=16,
                             replace=False, device=dev)
    seeds = np.random.default_rng(0).integers(0, 60, size=16)
    deg = np.diff(ptr)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(5):
        gt = sp.sample(gen, torch.tensor(seeds, device=dev))
        nid = gt.nodes["NID"].cpu().numpy()
        ev = gt.edge_valid.cpu().numpy()
        for i, v in enumerate(seeds):
            d = int(deg[v])
            picks = nid[16 + i * k: 16 + (i + 1) * k]
            valid = ev[i * k: (i + 1) * k]
            neigh = cs[ptr[v]:ptr[v + 1]].tolist()
            got = picks[valid].tolist()
            if d <= k:
                # every in-edge once, the slots past the degree invalid
                assert valid.sum() == d
                assert sorted(got) == sorted(neigh)
                assert (picks[~valid] == v).all()
            else:
                assert valid.all()
                assert len(set(got)) == k and set(got) <= set(neigh)


def test_without_replacement_marginals_are_uniform():
    # one hub with 12 in-neighbors, k = 4: each is drawn with p = 1/3
    d, k, trials = 12, 4, 1500
    cs = np.arange(1, d + 1, dtype=np.int32)
    ptr = np.array([0] + [d] * (d + 1), np.int64)
    sp = DeviceSampler.build(cs, ptr, fanouts=(k,), batch_size=1,
                             replace=False, device="cpu")
    gen = torch.Generator().manual_seed(42)
    seeds = torch.zeros(1, dtype=torch.int32)
    picks = np.stack([sp.sample(gen, seeds).nodes["NID"][1:].numpy()
                      for _ in range(trials)])
    assert all(len(set(row.tolist())) == k for row in picks)
    p = np.bincount(picks.reshape(-1), minlength=d + 1)[1:] / (trials * k)
    sigma = np.sqrt((1 / d) * (1 - 1 / d) / (trials * k))
    assert np.all(np.abs(p - 1 / d) < 5 * sigma), p


def test_build_validation(J):
    cases = [dict(csr_send=np.zeros(4, np.int32), ptr=np.array([0, 2, 4]),
                  fanouts=()),
             dict(csr_send=np.zeros(5, np.int32), ptr=np.array([0, 2, 4]),
                  fanouts=(2,)),
             dict(csr_send=np.zeros(4, np.int32), ptr=np.array([0, 2, 4]),
                  fanouts=(2, 0))]
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            J.DS.build(batch_size=2, **kw)
        with pytest.raises(ValueError) as terr:
            DeviceSampler.build(batch_size=2, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="seeds shape"):
        sp = DeviceSampler.build(np.zeros(4, np.int32), np.array([0, 2, 4]),
                                 fanouts=(2,), batch_size=2, device="cpu")
        sp.sample(torch.Generator(), torch.zeros(3, dtype=torch.int32))


def _jax_draw(J, sp, seeds, key, blocks):
    """JAX's draw: ``(nid [n_slots], edge_valid [e_total])`` and the JAX
    graph(s) it gives."""
    jseeds = J.jnp.asarray(seeds, J.jnp.int32)
    if blocks:
        bl, nid = J.jax.jit(lambda s, k, x: s.sample_blocks(k, x))(
            sp, J.jax.random.key(key), jseeds)
        ev = np.asarray(bl[0].edge_valid)[:sp.e_total]
        return np.asarray(nid)[:sp.n_slots], ev, (bl, nid)
    gb = J.jax.jit(lambda s, k, x: s.sample(k, x))(sp, J.jax.random.key(key),
                                                   jseeds)
    nid = np.asarray(gb.nodes["NID"])
    return nid[:sp.n_slots], np.asarray(gb.edge_valid)[:sp.e_total], gb


@pytest.mark.parametrize("layout", ["full", "blocks"])
@pytest.mark.parametrize("replace", [True, False])
def test_sage_on_jax_draw_matches_jax(J, replace, layout):
    """Two SAGE layers and a Dense head on JAX's draw: logits on the seed
    rows and every gradient, float64, JAX's XLA path against the port's
    plain path (K1's plain version), F64_TOL."""
    P = J.P
    cs, ptr, _, _ = _skewed_csr()
    n, bs, fanouts, d, nh, ncls = 60, 8, (4, 3), 5, 7, 3
    jsp = J.DS.build(cs, ptr, fanouts=fanouts, batch_size=bs,
                     build_spmm_aux=False, replace=replace)
    tsp = DeviceSampler.build(cs, ptr, fanouts=fanouts, batch_size=bs,
                              replace=replace, device="cpu")
    seeds = np.array([0, 7, 13, 21, 30, 3, 44, 59])
    blocks = layout == "blocks"
    nid, ev, jdraw = _jax_draw(J, jsp, seeds, 4, blocks)
    assert not ev.all()   # zero-degree seeds (and, without replacement,
    #                       short rows) leave invalid edges
    rng = np.random.default_rng(1)
    X = rng.standard_normal((n, d))
    cot = rng.standard_normal((bs, ncls))

    r = J.nnx.Rngs(2)
    jm = P.jax_params_f64(J.M.GNNChain(
        J.M.SAGEConv(d, nh, J.jax.nn.relu, rngs=r),
        J.M.SAGEConv(nh, nh, J.jax.nn.relu, rngs=r),
        J.nnx.Linear(nh, ncls, rngs=r)))
    kw = dict(device="cpu", dtype=torch.float64)
    tm = P.port_from_jax(TM.GNNChain(
        TM.SAGEConv(d, nh, torch.relu, **kw),
        TM.SAGEConv(nh, nh, torch.relu, **kw),
        torch.nn.Linear(nh, ncls, dtype=torch.float64)), jm)
    gd, params, rest = J.nnx.split(jm, J.nnx.Param, ...)
    jX = J.jnp.asarray(X)

    def jloss(p):
        m = J.nnx.merge(gd, p, rest)
        convs, head = list(m.layers)[:2], list(m.layers)[2]
        if blocks:
            bl, jnid = jdraw
            h = J.apply_blocks(bl, convs, jX[jnid])
        else:
            h = jX[jdraw.nodes["NID"]]
            for c in convs:
                h = c(jdraw, h)
        y = head(h[:bs])
        return J.jnp.sum(y * cot), y

    (_, jy), jgrads = J.jax.value_and_grad(jloss, has_aux=True)(params)

    tnid, tev = torch.tensor(nid), torch.tensor(ev)
    tX = torch.tensor(X)
    convs, head = list(tm.layers)[:2], tm.layers[2]
    if blocks:
        h = tgnn.apply_blocks(tsp.blocks_of(tnid, tev), convs,
                              tX[tnid.long()])
    else:
        g = tsp.graph_of(tnid, tev)
        h = tX[tnid.long()]
        for c in convs:
            h = c(g, h)
    ty = head(h[:bs])
    (ty * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **P.F64_TOL)
    P.assert_grads_match(tm, J.jax.tree.map(np.asarray,
                                            J.nnx.to_pure_dict(jgrads)),
                         **P.F64_TOL)


def test_sample_blocks_matches_full_graph():
    """``apply_blocks`` on the blocks equals the model on the full slot
    graph on the seed rows, for one draw; block 1's validity is the prefix
    of the full draw's."""
    cs, ptr, _, _ = _rand_csr(60, 700, 5)
    bs = 8
    sp = DeviceSampler.build(cs, ptr, fanouts=(4, 3), batch_size=bs,
                             device="cpu")
    gen = torch.Generator().manual_seed(9)
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    convs = [TM.SAGEConv(6, 10, torch.relu, **kw), TM.SAGEConv(10, 5, **kw)]
    X = torch.randn(60, 6, generator=torch.Generator().manual_seed(2))
    seeds = torch.arange(bs) * 3
    gen_state = gen.get_state()
    gb = sp.sample(gen, seeds)
    gen.set_state(gen_state)
    blocks, nid = sp.sample_blocks(gen, seeds)
    assert torch.equal(nid, gb.nodes["NID"])
    x = X[nid.long()]
    for c in convs:
        x = c(gb, x)
    trimmed = tgnn.apply_blocks(blocks, convs, X[nid.long()])
    torch.testing.assert_close(trimmed[:bs], x[:bs], rtol=1e-6, atol=1e-6)
    assert blocks[0].num_nodes == sp.n_slots
    assert blocks[1].num_nodes < sp.n_slots
    e1 = sp.block_sizes[1][0]
    assert e1 < sp.e_total
    assert torch.equal(blocks[1].edge_valid, gb.edge_valid[:e1])


def test_aggregation_oracle_mean_and_sum(J):
    """propagate on a sampled graph with invalid edges == a numpy reduction
    over the valid edges; and == JAX's propagate on JAX's draw."""
    cs, ptr, _, _ = _skewed_csr()
    sp = DeviceSampler.build(cs, ptr, fanouts=(3,), batch_size=16,
                             replace=False, device="cpu")
    seeds = torch.tensor(np.arange(16) * 3 % 60)
    gb = sp.sample(torch.Generator().manual_seed(7), seeds)
    ev = gb.edge_valid.numpy()
    assert not ev.all()
    x = np.random.default_rng(0).standard_normal((60, 5))
    nid = gb.nodes["NID"].numpy()
    X = torch.tensor(x[nid])
    got_sum = TO.propagate(TO.copy_xj, gb, "sum", xj=X).numpy()
    got_mean = TO.propagate(TO.copy_xj, gb, "mean", xj=X).numpy()
    s, r = gb.senders.numpy(), gb.receivers.numpy()
    want = np.zeros((sp.n_slots, 5))
    cnt = np.zeros(sp.n_slots)
    for i in np.flatnonzero(ev):
        want[r[i]] += x[nid[s[i]]]
        cnt[r[i]] += 1
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_sum, want, **tol)
    np.testing.assert_allclose(got_mean, want / np.maximum(cnt, 1)[:, None],
                               **tol)
    # degree and the adjacency count the valid in-edges too, as JAX's do
    # through edge_mask
    np.testing.assert_array_equal(
        tgnn.degree(gb, dir="in", dtype=torch.float64).numpy(), cnt)
    np.testing.assert_array_equal(
        tgnn.adjacency_matrix(gb, dtype=torch.float64).sum(0).numpy(), cnt)

    jsp = J.DS.build(cs, ptr, fanouts=(3,), batch_size=16,
                     build_spmm_aux=False, replace=False)
    jnid, jev, jgb = _jax_draw(J, jsp, seeds.numpy(), 7, False)
    tg = sp.graph_of(torch.tensor(jnid), torch.tensor(jev))
    XJ = x[np.asarray(jgb.nodes["NID"])]
    for aggr in ("sum", "mean"):
        jy = np.asarray(J.ops.propagate(J.ops.copy_xj, jgb, aggr,
                                        xj=J.jnp.asarray(XJ)))
        ty = TO.propagate(TO.copy_xj, tg, aggr,
                          xj=torch.tensor(x[jnid])).numpy()
        np.testing.assert_allclose(ty, jy[:sp.n_slots], **J.P.F64_TOL)


def _valid_graph():
    cs, ptr, _, _ = _skewed_csr()
    sp = DeviceSampler.build(cs, ptr, fanouts=(3,), batch_size=6,
                             device="cpu")
    return sp.sample(torch.Generator().manual_seed(1),
                     torch.tensor([0, 1, 8, 9, 10, 30]))


def _routes():
    n, h, d = 24, 2, 3

    def rn(*shape):
        return torch.randn(*shape, dtype=torch.float64)

    kw = dict(device="cpu", dtype=torch.float64)
    return {
        "apply_edges": lambda g: TO.apply_edges(TO.xi_sub_xj, g, xi=rn(n, d),
                                                xj=rn(n, d)),
        "apply_edges xi_dot_xj (K13)": lambda g: TO.apply_edges(
            TO.xi_dot_xj, g, xi=rn(n, d), xj=rn(n, d)),
        "aggregate_neighbors max (K14)": lambda g: TO.aggregate_neighbors(
            g, "max", rn(g.num_edges, d)),
        "aggregate_neighbors sum": lambda g: TO.aggregate_neighbors(
            g, "sum", rn(g.num_edges, d)),
        "propagate of an edge function": lambda g: TO.propagate(
            TO.xi_sub_xj, g, "mean", xi=rn(n, d), xj=rn(n, d)),
        "propagate max": lambda g: TO.propagate(TO.copy_xj, g, "max",
                                                xj=rn(n, d)),
        "softmax_edge_neighbors": lambda g: TO.softmax_edge_neighbors(
            g, rn(g.num_edges, h)),
        "reduce_edges": lambda g: TO.reduce_edges("sum", g,
                                                  rn(g.num_edges, h)),
        "gat_attention (K3-K5, K12)": lambda g: TO.gat_attention(
            g, rn(n, h), rn(n, h), rn(n, h, d), 0.2),
        "gatv2_attention (K9-K11)": lambda g: TO.gatv2_attention(
            g, rn(n, h, d), rn(n, h, d), rn(d, h), 0.2),
        "dot_attention (K6-K8)": lambda g: TO.dot_attention(
            g, rn(n, h, d), rn(n, h, d), rn(n, h, d)),
        "dot_attention_logits (K13)": lambda g: TO.dot_attention_logits(
            g, rn(n, h, d), rn(n, h, d)),
        "attention_aggregate (K12)": lambda g: TO.attention_aggregate(
            g, rn(g.num_edges, h), rn(g.num_edges, h, d)),
        "GATConv": lambda g: TM.GATConv(d, 2, heads=h, **kw)(g, rn(n, d)),
        "EdgeConv": lambda g: TM.EdgeConv(TM.MLP([2 * d, 2], **kw))(
            g, rn(n, d)),
        "GCNConv bipartite": lambda g: TM.GCNConv(d, 2, **kw)(
            g, (rn(n, d), rn(6, d))),
        "query has_self_loops": lambda g: tgnn.has_self_loops(g),
        "query adjacency_list": lambda g: tgnn.adjacency_list(g),
        "batch": lambda g: tgnn.batch([g, g], device="cpu"),
    }


@pytest.mark.parametrize("route", list(_routes()))
def test_routes_that_do_not_honour_edge_valid_raise(route):
    g = _valid_graph()
    assert g.num_nodes == 24 and not g.edge_valid.all()
    with pytest.raises(ValueError, match="edge_valid"):
        _routes()[route](g)


def test_sage_train_smoke():
    """Twelve Adam steps of SAGE over DeviceSampler batches on the CPU: the
    loss falls (JAX's test_sage_train_step_smoke)."""
    cs, ptr, _, _ = _rand_csr(100, 1200, 4)
    sp = DeviceSampler.build(cs, ptr, fanouts=(4, 3), batch_size=8,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(100, 6, generator=gen)
    y = torch.randint(0, 3, (100,), generator=gen)
    kw = dict(generator=torch.Generator().manual_seed(1), device="cpu")
    model = TM.GNNChain(TM.SAGEConv(6, 16, torch.relu, **kw),
                        torch.nn.Linear(16, 3))
    opt = torch.optim.Adam(model.parameters(), 5e-2)
    seeds = torch.randint(0, 100, (8,), generator=gen)
    losses = []
    for _ in range(12):
        gb = sp.sample(gen, seeds)
        nid = gb.nodes["NID"].long()
        loss = torch.nn.functional.cross_entropy(model(gb, X[nid])[:8],
                                                 y[nid[:8]])
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


# ---- on the card ----------------------------------------------------------

@pytest.mark.gpu
def test_k1_on_block_csrs_matches_plain():
    """K1 over the blocks of a (1024, (15, 10)) draw, weighted by the
    validity as SAGE runs it: block 0's receiver CSR at D = 100 (a row of
    25 float4 per node, most rows empty), block 1's at D = 256 and its
    sender CSR at D = 256 (the backward), against the plain version; and
    two SAGE layers on the blocks, forward and backward, card vs CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev = torch.device("cuda")
    # skewed in-degrees with a few empty rows, as the north-star graph's
    cs, ptr, _, _ = _rand_csr(40_000, 600_000, 3, isolated=500)
    sp = DeviceSampler.build(cs, ptr, fanouts=(15, 10), batch_size=1024,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    seeds = torch.randint(0, 40_000, (1024,), generator=gen, device=dev)
    blocks, nid = sp.sample_blocks(gen, seeds)
    b0, b1 = blocks
    w0, w1 = (b.edge_valid.float() for b in blocks)
    assert not b0.edge_valid.all()
    cases = [(b0.indptr_r, b0.col_r, None, w0, 100, b0.num_nodes),
             (b1.indptr_r, b1.col_r, None, w1, 256, b1.num_nodes),
             (b1.indptr_s, b1.col_s, b1.eid_s, w1, 256, b1.num_nodes)]
    for indptr, col, eid, w, d, rows in cases:
        x = torch.randn(rows, d, generator=gen, device=dev)
        y = S.spmm_csr(indptr, col, eid, w, x)
        torch.testing.assert_close(y, S.spmm_plain(indptr, col, eid, w, x),
                                   rtol=1e-5, atol=1e-4)
    X = torch.randn(40_000, 100, generator=gen, device=dev)
    kw = dict(generator=torch.Generator().manual_seed(0), device=dev)
    convs = torch.nn.ModuleList([TM.SAGEConv(100, 256, torch.relu, **kw),
                                 TM.SAGEConv(256, 256, torch.relu, **kw)])
    cpu = [c.to("cpu", torch.float64) for c in
           __import__("copy").deepcopy(convs)]
    out = tgnn.apply_blocks(blocks, convs, X[nid.long()])[:1024]
    out.square().sum().backward()
    ref = tgnn.apply_blocks([b.to("cpu") for b in blocks], cpu,
                            X[nid.long()].cpu().double())[:1024]
    ref.square().sum().backward()
    # float32 on the card against float64: the card's rounding only
    torch.testing.assert_close(out.cpu().double(), ref, rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(convs.parameters(), (p for c in cpu
                                         for p in c.parameters())):
        err = (a.grad.cpu().double() - b.grad).norm() / b.grad.norm()
        assert err < 1e-3


@pytest.mark.gpu
def test_device_graph_on_the_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(0, 5000, 170_000).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, 5000, 170_000).astype(np.int32))
    w = torch.from_numpy(rng.random(170_000))
    a = tgnn.device_graph(s, r, num_nodes=6000, edge_weight=w)
    b = tgnn.device_graph(s.cuda(), r.cuda(), num_nodes=6000,
                          edge_weight=w.cuda())
    for f in ("senders", "receivers", "indptr_r", "col_r", "indptr_s",
              "col_s", "eid_s", "indptr_g", "indptr_ge", "edge_weight"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
