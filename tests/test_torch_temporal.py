"""Temporal graphs and the recurrent layers against graphneuralnetworks_tpu.

Both packages run on the CPU from the same numpy graphs, inputs and (JAX's,
loaded through ``interop.load_jax_params``) parameters: the JAX side with
x64, its node arrays padded, the port in float64 at true size; real rows
only are compared. The JAX recurrence is a ``lax.scan``, the port's a
Python loop over time.

Tolerances:
- ``F64_TOL`` wherever both sides compute the same float64 function (only
  the order of the sums differs). The ChebConv cells (GConvGRU,
  GConvLSTM) are held so with λ_max fixed to one constant on both sides:
  their default λ_max comes from a power iteration whose start vector
  differs between the packages (ROADMAP, "Documented JAX behaviours").
- The default-λ path of GConvGRU once, on a bidirected graph whose power
  iteration converges: each side's λ_max is held to the exact result of a
  power iteration from its own start vector (``tests/test_torch_cheb.py``'s
  derivation), and the layer to JAX within ``max |∂f/∂λ|`` times the two
  sides' gap from the true λ_max, plus ``F64_TOL``.
"""

import copy

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu as jgnn  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu.models import temporalconv as JTC  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import query as TQ  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.models import temporalconv as TTC  # noqa: E402
from test_torch_cheb import (POWER_ROUNDING, _bipartite,  # noqa: E402
                             _jax_start, _power_result)
from torch_parity import (F64_TOL, jax_params_f64, pad_rows,  # noqa: E402
                          port_from_jax, t)

KW = dict(device="cpu", dtype=torch.float64)
T, DIN, DOUT = 3, 3, 4
LAM = 1.7


def _graph_pair(n=20, e=70, seed=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    return (jgnn.graph(s, r, num_nodes=n),
            tgnn.graph(s, r, num_nodes=n, device="cpu"))


def _cells(name, seed):
    """The JAX cell (float64) and the port's, its parameters loaded."""
    r = nnx.Rngs(seed)
    make = {
        "GConvGRU": (lambda: JM.GConvGRUCell(DIN, DOUT, 3, rngs=r),
                     lambda: TM.GConvGRUCell(DIN, DOUT, 3, **KW)),
        "GConvLSTM": (lambda: JM.GConvLSTMCell(DIN, DOUT, 2, rngs=r),
                      lambda: TM.GConvLSTMCell(DIN, DOUT, 2, **KW)),
        "DCGRU": (lambda: JM.DCGRUCell(DIN, DOUT, 2, rngs=r),
                  lambda: TM.DCGRUCell(DIN, DOUT, 2, **KW)),
        "EvolveGCNO": (lambda: JM.EvolveGCNOCell(DIN, DOUT, rngs=r),
                       lambda: TM.EvolveGCNOCell(DIN, DOUT, **KW)),
        "TGCN": (lambda: JM.TGCNCell(DIN, DOUT, rngs=r),
                 lambda: TM.TGCNCell(DIN, DOUT, **KW)),
    }[name]
    jc = make[0]()
    if name == "EvolveGCNO":
        # a nonzero LSTM bias, so that its mapping is exercised too
        b = np.random.default_rng(seed).standard_normal(
            jc.lstm.dense_h.bias.shape) * 0.1
        jc.lstm.dense_h.bias[...] = jnp.asarray(b)
    jm = jax_params_f64(JM.GNNRecurrence(jc))
    return jm, port_from_jax(TM.GNNRecurrence(make[1]()), jm)


def _fix_lambda(monkeypatch, lam=LAM):
    """One constant λ_max on both sides (per graph), counted on the
    port's."""
    calls = []
    monkeypatch.setattr(JTC, "cheb_lambda_max",
                        lambda g, dtype=jnp.float32, power_iters=50:
                        jnp.full((g.g_pad,), lam, dtype))

    def port(g, dtype=torch.float32, power_iters=50):
        calls.append(1)
        return torch.full((g.num_graphs,), lam, dtype=dtype)
    monkeypatch.setattr(TTC, "cheb_lambda_max", port)
    return calls


def _grads_match(tm, gp):
    """Every parameter's gradient against JAX's (``gp``, an nnx state),
    the LSTM's two biases against its one (both add to the same gates)."""
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(gp)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 ref.named_parameters()):
        want = q.detach() if not name.endswith("bias_ih") else \
            ref.get_parameter(name[:-2] + "hh").detach()
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(),
                                   err_msg=name, **F64_TOL)


def _jax_state(m, x):
    """EvolveGCNO's initial state in float64 for JAX's scan (its own
    ``initial_state`` makes the LSTM carry float32, which a float64 scan
    refuses); the default for every other cell."""
    cell = m.cell
    if not isinstance(cell, JM.EvolveGCNOCell):
        return None
    w = cell.conv.weight[...].reshape(-1)
    return {"weight": w, "lstm": (jnp.zeros_like(w), jnp.zeros_like(w))}


def _run_static(jm, tm, jg, tg, x, cot):
    """Forward and the gradients (x and every parameter) of ``sum(out *
    cot)`` through GNNRecurrence on a static graph; returns both sides
    flattened and JAX's parameter gradients."""
    n = tg.num_nodes
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, xp):
        m = nnx.merge(gd, p, rest)
        y = m(jg, xp, _jax_state(m, xp))[:, :n]
        return jnp.sum(y * cot), y

    jx = jnp.asarray(np.stack([pad_rows(v, jg.n_pad) for v in x]))
    (_, jy), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jx)
    return (np.concatenate([np.asarray(jy).ravel(),
                            np.asarray(gx)[:, :n].ravel()]),
            _port_static(tm, tg, x, cot), gp)


def _port_static(tm, tg, x, cot):
    """The port's side of :func:`_run_static`, flattened."""
    tx = t(x, grad=True)
    tm.zero_grad()
    ty = tm(tg, tx)
    assert ty.shape == (len(x), tg.num_nodes, DOUT)
    (ty * t(cot)).sum().backward()
    return np.concatenate([ty.detach().numpy().ravel(),
                           tx.grad.numpy().ravel()])


CELLS = ["GConvGRU", "GConvLSTM", "DCGRU", "EvolveGCNO", "TGCN"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_through_gnn_recurrence_match_jax(monkeypatch, name):
    """Each cell over T = 3 steps of ``[T, N, 3]`` features on one directed
    graph: the stacked ``[T, N, 4]`` outputs and the gradients of the
    input and of every parameter. The ChebConv cells take λ_max fixed on
    both sides and compute it once per call (``static_context``), not once
    per step."""
    calls = _fix_lambda(monkeypatch)
    jg, tg = _graph_pair(seed=CELLS.index(name))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, tg.num_nodes, DIN))
    cot = rng.standard_normal((T, tg.num_nodes, DOUT))
    jm, tm = _cells(name, CELLS.index(name))
    jflat, tflat, gp = _run_static(jm, tm, jg, tg, x, cot)
    np.testing.assert_allclose(tflat, jflat, **F64_TOL)
    _grads_match(tm, gp)
    assert len(calls) == (1 if name.startswith("GConv") else 0)


def test_gconv_gru_default_lambda_matches_jax():
    """GConvGRU with λ_max from each package's own power iteration (50
    products, matrix-free, once per call) on a bidirected graph of 48
    nodes: each side's λ_max equals the exact result for its start
    vector, and the outputs and gradients agree within the derived
    tolerance (module docstring)."""
    n = 48
    s, r = _bipartite(n, 16, seed=7)
    jg = jgnn.graph(s, r, num_nodes=n)
    tg = tgnn.graph(s, r, num_nodes=n, device="cpu")
    L = tgnn.normalized_laplacian(tg, dtype=torch.float64).numpy()
    t_want, top = _power_result(
        L, TQ.start_vector((n, 1), torch.float64, "cpu").numpy()[:, 0], 50)
    j_want, _ = _power_result(L, _jax_start((jg.n_pad, 1))[:n, 0], 50)
    t_lam = float(TM.cheb_lambda_max(tg, torch.float64)[0])
    j_lam = float(JM.cheb_lambda_max(jg, jnp.float64)[0])
    assert abs(t_lam - t_want) <= POWER_ROUNDING
    assert abs(j_lam - j_want) <= POWER_ROUNDING
    err = abs(t_want - top) + abs(j_want - top) + 2 * POWER_ROUNDING
    assert err < 1e-8, "the iteration has not converged on this graph"
    rng = np.random.default_rng(8)
    x = rng.standard_normal((T, n, DIN))
    cot = rng.standard_normal((T, n, DOUT))
    jm, tm = _cells("GConvGRU", 9)
    jflat, tflat, _ = _run_static(jm, tm, jg, tg, x, cot)

    def at(lam):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TTC, "cheb_lambda_max",
                       lambda g, dtype, power_iters=50:
                       torch.full((1,), lam, dtype=dtype))
            return _port_static(tm, tg, x, cot)
    h = 1e-4
    slope = np.abs(at(top + h) - at(top - h)).max() / (2 * h)
    np.testing.assert_allclose(tflat, jflat, rtol=F64_TOL["rtol"],
                               atol=F64_TOL["atol"] + 2 * slope * err)


def _snapshots(sizes, seed, uniform=False):
    """Snapshots of the given node counts (JAX's and the port's), each with
    its own random edges."""
    rng = np.random.default_rng(seed)
    j, p = [], []
    for n in sizes:
        e = 3 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        j.append(jgnn.graph(s, r, num_nodes=n))
        p.append(tgnn.graph(s, r, num_nodes=n, device="cpu"))
    return (jgnn.TemporalGraph.from_snapshots(j, uniform=uniform),
            tgnn.TemporalGraph.from_snapshots(p, uniform=uniform))


def _run_snapshots(jm, tm, jtg, ttg, xs, cots, reduce_out):
    """Forward and gradients over a TemporalGraph: ``xs`` one input per
    snapshot; ``reduce_out`` takes the model's output (a list, or a
    tensor) and the cotangents to one scalar on either side."""
    gd, params, rest = nnx.split(jm, nnx.Param, ...)
    pads = [g.n_pad for g in jtg.snapshots]

    def jloss(p, xp):
        out = nnx.merge(gd, p, rest)(jtg, xp)
        return reduce_out(out, cots, jnp), out

    jx = [jnp.asarray(pad_rows(v, npad)) for v, npad in zip(xs, pads)]
    (_, jout), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jx)
    tx = [t(v, grad=True) for v in xs]
    tm.zero_grad()
    tout = tm(ttg, tx)
    reduce_out(tout, cots, torch).backward()
    for i, v in enumerate(xs):
        np.testing.assert_allclose(tx[i].grad.numpy(),
                                   np.asarray(gx[i])[: len(v)],
                                   err_msg=f"dx[{i}]", **F64_TOL)
    _grads_match(tm, gp)
    return jout, tout


def test_evolvegcno_on_snapshots_matches_jax():
    """EvolveGCNO over three snapshots of 12, 17 and 9 nodes: the weight
    evolves through the LSTM (its input the previous weight, flattened),
    one output per snapshot, every gradient."""
    sizes = (12, 17, 9)
    jtg, ttg = _snapshots(sizes, 11)
    rng = np.random.default_rng(12)
    xs = [rng.standard_normal((n, DIN)) for n in sizes]
    cots = [rng.standard_normal((n, DOUT)) for n in sizes]
    jm, tm = _cells("EvolveGCNO", 13)

    def reduce_out(out, cots, xp):
        return sum(xp.sum(o[: len(c)] * (jnp.asarray(c) if xp is jnp
                                         else t(c)))
                   for o, c in zip(out, cots))

    jout, tout = _run_snapshots(jm, tm, jtg, ttg, xs, cots, reduce_out)
    assert isinstance(tout, list) and len(tout) == 3
    for i, n in enumerate(sizes):
        np.testing.assert_allclose(tout[i].detach().numpy(),
                                   np.asarray(jout[i])[:n], **F64_TOL)


def _a3tgcn(seed):
    jm = jax_params_f64(JM.A3TGCN(DIN, DOUT, rngs=nnx.Rngs(seed)))
    return jm, port_from_jax(TM.A3TGCN(DIN, DOUT, **KW), jm)


def test_a3tgcn_on_a_static_graph_matches_jax():
    """TGCN over T = 3 steps, scored per step, softmax over time: the
    ``[N, 4]`` output and every gradient."""
    jg, tg = _graph_pair(seed=14)
    n = tg.num_nodes
    rng = np.random.default_rng(15)
    x, cot = rng.standard_normal((T, n, DIN)), rng.standard_normal((n, DOUT))
    jm, tm = _a3tgcn(16)
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, xp):
        y = nnx.merge(gd, p, rest)(jg, xp)[:n]
        return jnp.sum(y * cot), y

    jx = jnp.asarray(np.stack([pad_rows(v, jg.n_pad) for v in x]))
    (_, jy), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jx)
    tx = t(x, grad=True)
    ty = tm(tg, tx)
    assert ty.shape == (n, DOUT)
    (ty * t(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx)[:, :n],
                               **F64_TOL)
    _grads_match(tm, gp)


def test_a3tgcn_on_a_uniform_temporal_graph_matches_jax():
    """Over three snapshots of one node count and different edges
    (``from_snapshots(uniform=True)``): the per-snapshot outputs stacked
    for the softmax over time; every gradient."""
    n = 14
    jtg, ttg = _snapshots((n, n, n), 17, uniform=True)
    rng = np.random.default_rng(18)
    xs = [rng.standard_normal((n, DIN)) for _ in range(3)]
    cot = rng.standard_normal((n, DOUT))
    jm, tm = _a3tgcn(19)

    def reduce_out(out, cots, xp):
        c = jnp.asarray(cots) if xp is jnp else t(cots)
        return xp.sum(out[:n] * c)

    jout, tout = _run_snapshots(jm, tm, jtg, ttg, xs, cot, reduce_out)
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout)[:n], **F64_TOL)


def test_a3tgcn_refuses_unequal_snapshots():
    """Snapshots of unequal node counts: the recurrence itself fails on
    both sides (its state has another number of rows; JAX's only where
    the padded counts differ), and per-snapshot outputs of unequal shapes
    reach A3TGCN's own ``ValueError`` (JAX ``temporalconv.py:327-338``)."""
    sizes = (14, 23, 14)
    jtg, ttg = _snapshots(sizes, 20)
    assert len({g.n_pad for g in jtg.snapshots}) > 1
    rng = np.random.default_rng(25)
    xs = [rng.standard_normal((m, DIN)) for m in sizes]
    jm, tm = _a3tgcn(26)
    with pytest.raises(TypeError):
        jm(jtg, [jnp.asarray(pad_rows(v, g.n_pad))
                 for v, g in zip(xs, jtg.snapshots)])
    with pytest.raises(RuntimeError):
        tm(ttg, [t(v) for v in xs])
    tm.tgcn.forward = lambda g, x, state=None: [t(v)[:, :DOUT] for v in x]
    with pytest.raises(ValueError, match="A3TGCN"):
        tm(ttg, xs)


# ---- TemporalGraph ----------------------------------------------------------

def test_temporal_graph_container_matches_jax():
    """Counts, time indexing by int, slice and list, inserting and removing
    a snapshot, node features and ``tgdata``, beside JAX's."""
    sizes = (6, 9, 7, 11)
    rng = np.random.default_rng(21)
    j, p = [], []
    for n in sizes:
        s, r = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
        x = rng.standard_normal((n, 2))
        j.append(jgnn.graph(s, r, num_nodes=n, nodes={"x": x}))
        p.append(tgnn.graph(s, r, num_nodes=n, nodes={"x": x},
                            device="cpu"))
    jt = jgnn.TemporalGraph.from_snapshots(j[:3], tgdata={"u": [1.0]})
    tt = tgnn.TemporalGraph.from_snapshots(p[:3], tgdata={"u": [1.0]})

    def same(a, b):
        assert len(a) == len(b) == a.num_snapshots == b.num_snapshots
        assert [int(v) for v in a.num_nodes] == b.num_nodes
        assert [int(v) for v in a.num_edges] == b.num_edges

    same(jt, tt)
    assert tt[1] is p[1]
    same(jt[1:], tt[1:])
    same(jt[[2, 0]], tt[[2, 0]])
    same(jt.add_snapshot(1, j[3]), tt.add_snapshot(1, p[3]))
    same(jt.remove_snapshot(0), tt.remove_snapshot(0))
    assert len(tt) == 3                          # functional updates
    for a, b, n in zip(jt.node_features("x"), tt.node_features("x"), sizes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a)[:n])
    assert tt.node_features("y") == [None] * 3
    tt2 = tt.with_tgdata(v=2)
    assert tt2.tgdata == {"u": [1.0], "v": 2} and tt.tgdata == {"u": [1.0]}


def test_uniform_and_stacked_need_equal_sizes():
    """``from_snapshots(uniform=True)`` on snapshots of 8, 12 and 8 nodes
    (24, 36 and 24 edges, node features and edge weights) against JAX's:
    each padded to 12 nodes and 36 edges, the real edges and rows where
    JAX has them, pad rows 0, pad edges marked invalid by ``edge_valid``;
    ``stacked()`` stacks them as JAX's does; A3TGCN over them matches JAX
    (outputs and every gradient) on the real rows. Snapshots of unequal
    sizes not made uniform still refuse ``stacked()``."""
    rng = np.random.default_rng(22)
    sizes, j, p = (8, 12, 8), [], []
    for n in sizes:
        s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        x, w = rng.standard_normal((n, DIN)), rng.random(3 * n) + 0.5
        j.append(jgnn.graph(s, r, num_nodes=n, nodes={"x": x},
                            edge_weight=w))
        p.append(tgnn.graph(s, r, num_nodes=n, nodes={"x": x},
                            edge_weight=w, device="cpu"))
    with pytest.raises(ValueError, match="uniform=True"):
        tgnn.TemporalGraph.from_snapshots(p).stacked()
    jtg = jgnn.TemporalGraph.from_snapshots(j, uniform=True)
    ttg = tgnn.TemporalGraph.from_snapshots(p, uniform=True)
    assert ttg.num_nodes == [12] * 3 and ttg.num_edges == [36] * 3
    js, ts = jtg.stacked(), ttg.stacked()
    assert ts.senders.shape == (3, 36) and ts.x.shape == (3, 12, DIN)
    for i, n in enumerate(sizes):
        e = 3 * n
        np.testing.assert_array_equal(ts.edge_valid[i].numpy(),
                                      np.arange(36) < e)
        for f in ("senders", "receivers", "edge_weight"):
            np.testing.assert_array_equal(getattr(ts, f)[i, :e].numpy(),
                                          np.asarray(getattr(js, f))[i, :e])
        np.testing.assert_array_equal(ts.x[i, :n].numpy(),
                                      np.asarray(js.x)[i, :n])
        assert not ts.x[i, n:].any() and not ts.edge_weight[i, e:].any()

    xs = [pad_rows(rng.standard_normal((n, DIN)), 12) for n in sizes]
    cot = rng.standard_normal((12, DOUT))
    jm, tm = _a3tgcn(24)

    def reduce_out(out, cots, xp):
        c = jnp.asarray(cots) if xp is jnp else t(cots)
        return xp.sum(out[:12] * c)

    jout, tout = _run_snapshots(jm, tm, jtg, ttg, xs, cot, reduce_out)
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout)[:12], **F64_TOL)


def test_lambda_max_given_to_the_recurrence_skips_the_iteration(
        monkeypatch):
    """``GNNRecurrence(g, x, lambda_max=...)`` hands the given λ_max to
    every step and runs no power iteration; the result equals the default
    call's when the iteration gives that λ_max."""
    calls = _fix_lambda(monkeypatch)
    _, tg = _graph_pair(seed=27)
    x = torch.randn(T, tg.num_nodes, DIN, dtype=torch.float64)
    rnn = TM.GConvGRU(DIN, DOUT, 2, **KW)
    want = rnn(tg, x)
    assert len(calls) == 1
    got = rnn(tg, x, lambda_max=torch.full((1,), LAM, dtype=torch.float64))
    assert len(calls) == 1
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    _, ttg = _snapshots((6, 6), 28)
    with pytest.raises(ValueError, match="TemporalGraph"):
        rnn(ttg, [x[0][:6], x[1][:6]], lambda_max=LAM)


def test_temporal_graph_through_recurrence_runs_per_snapshot():
    """GNNRecurrence over a TemporalGraph passes no static context: a
    ChebConv cell computes λ_max once per snapshot, each on its own
    graph (two snapshots of one node count, other edges)."""
    sizes = (10, 10)
    _, ttg = _snapshots(sizes, 24)
    seen = []
    real = TTC.cheb_lambda_max

    def spy(g, dtype=torch.float32, power_iters=50):
        seen.append(g.num_nodes)
        return real(g, dtype, power_iters)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTC, "cheb_lambda_max", spy)
        out = TM.GConvGRU(DIN, DOUT, 2, **KW)(
            ttg, [torch.randn(n, DIN, dtype=torch.float64) for n in sizes])
    assert [o.shape for o in out] == [(n, DOUT) for n in sizes]
    assert seen == list(sizes)
    assert len({id(g) for g in ttg.snapshots}) == 2
