"""ChebConv's two paths, its path switch and λ_max vs graphneuralnetworks_tpu.

The JAX package's ChebConv takes the dense ``scaled_laplacian`` (out-edge
convention, 100 power iterations) below 2048 padded nodes and the
matrix-free operator (in-edge convention, 50 power iterations) from there
on or whenever ``lambda_max`` is given (``models/conv.py:275-316``). The
port switches at the same graph size (N >= 2048 nodes: JAX's default
``n_pad = round_up(N + 1, 8)`` > 2048).

- λ fixed: each package's power iteration is replaced by one constant, so
  the layers must agree at ``F64_TOL``, on a directed graph (where the two
  conventions differ) at N = 2047 and 2048, and with ``lambda_max=`` given
  as a ``[G]`` tensor on a batch.
- λ from the power iterations: the two packages start from different
  vectors (JAX's ``jax.random.key(20240607)`` draw, the port's
  ``torch.Generator`` seeded 20240607), so on bidirected graphs each side's
  λ is held to the exact power-iteration result derived from that graph's
  eigendecomposition and its own start vector (:func:`_power_result`), and
  to ``numpy.linalg.eigvalsh``; the layers are held to each other at the
  derived tolerance of :func:`_layer_tol`.
"""

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
from graphneuralnetworks_tpu import query as JQ  # noqa: E402
from graphneuralnetworks_tpu.models import conv as jconv  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import query as TQ  # noqa: E402
from graphneuralnetworks_tpu_torch.models import conv as tconv  # noqa: E402
from torch_parity import (F64_TOL, jax_params_f64, pad_rows,  # noqa: E402
                          port_from_jax, t)

KW = dict(device="cpu", dtype=torch.float64)
SEED = 20240607
# rounding of a float64 power iteration against its exact-arithmetic result
# (a few hundred products of unit vectors: ~1e-13), with room
POWER_ROUNDING = 1e-11


def _bipartite(n, deg, seed, extra=12, directed=False):
    """``n`` nodes in two halves joined by ``n * deg / 2`` random edges,
    plus ``extra`` edges inside the first half (so the graph is not
    bipartite and λ_max is below 2), deduplicated; both directions unless
    ``directed``. Dense joins of two halves keep λ_max isolated from the
    rest of the spectrum: the power iterations converge to rounding."""
    rng = np.random.default_rng(seed)
    a = n // 2
    s = np.concatenate([rng.integers(0, a, n * deg // 2),
                        rng.integers(0, a, extra)])
    r = np.concatenate([rng.integers(a, n, n * deg // 2),
                        rng.integers(0, a, extra)])
    keep = s != r
    pairs = np.unique(np.stack([s[keep], r[keep]], 1), axis=0)
    s, r = pairs[:, 0], pairs[:, 1]
    if not directed:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    return s, r


def _pair(s, r, n, **kw):
    return (jgnn.graph(s, r, num_nodes=n, **kw),
            tgnn.graph(s, r, num_nodes=n, device="cpu", **kw))


def _layers(din, dout, k, seed=0):
    jm = jax_params_f64(JM.ChebConv(din, dout, k, rngs=nnx.Rngs(seed)))
    return jm, port_from_jax(TM.ChebConv(din, dout, k, **KW), jm)


def _run(jm, tm, jg, tg, x, cot, **call):
    """Forward and the gradients of x and every parameter, both sides,
    flattened into one vector each."""
    n = tg.num_nodes
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p, xp):
        y = nnx.merge(gd, p, rest)(jg, xp, **call)[:n]
        return jnp.sum(y * cot), y

    (_, jy), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        params, jnp.asarray(pad_rows(x, jg.n_pad)))
    tx = t(x, grad=True)
    tm.zero_grad()
    ty = tm(tg, tx, **call)
    (ty * t(cot)).sum().backward()
    jflat = np.concatenate([np.asarray(jy).ravel(), np.asarray(gx)[:n].ravel(),
                            np.asarray(gp["weight"]).ravel(),
                            np.asarray(gp["bias"]).ravel()])
    tflat = np.concatenate([ty.detach().numpy().ravel(),
                            tx.grad.numpy().ravel(),
                            tm.weight.grad.numpy().ravel(),
                            tm.bias.grad.numpy().ravel()])
    return jflat, tflat


def _fix_lambda(monkeypatch, lam):
    """Replace every power iteration of both packages by the constant
    ``lam`` (per graph where they return ``[G]``)."""
    monkeypatch.setattr(JQ, "_power_iteration_eigmax",
                        lambda M, iters=50: jnp.asarray(lam, M.dtype))
    monkeypatch.setattr(JQ, "_per_graph_eigmax",
                        lambda g, L, iters=100: jnp.full((g.g_pad,), lam,
                                                         L.dtype))
    monkeypatch.setattr(jconv, "cheb_lambda_max",
                        lambda g, dtype=jnp.float32, power_iters=50:
                        jnp.full((g.g_pad,), lam, dtype))
    def port(g, apply, dtype, iters):
        return torch.full((g.num_graphs,), lam, dtype=dtype)

    monkeypatch.setattr(TQ, "power_eigmax", port)
    monkeypatch.setattr(tconv, "power_eigmax", port)


@pytest.mark.parametrize("n", [2047, 2048])
def test_path_switch_matches_jax_on_a_directed_graph(monkeypatch, n):
    """N = 2047 is JAX's dense path (n_pad 2048), N = 2048 its matrix-free
    one (n_pad 2056). With λ fixed on both sides the port must match JAX
    at F64_TOL, forward and every gradient; on this directed graph the two
    paths give different results, so only the same switch passes."""
    s, r = _bipartite(n, 4, seed=n, directed=True)
    jg, tg = _pair(s, r, n)
    assert (jg.n_pad > 2048) is (n == 2048)
    rng = np.random.default_rng(n)
    x, cot = rng.standard_normal((n, 3)), rng.standard_normal((n, 4))
    _fix_lambda(monkeypatch, 1.9)
    taken = []
    dense = TQ.scaled_laplacian
    monkeypatch.setattr(tconv, "scaled_laplacian",
                        lambda *a, **k: taken.append("dense") or dense(*a,
                                                                       **k))
    jm, tm = _layers(3, 4, 3)
    jflat, tflat = _run(jm, tm, jg, tg, x, cot)
    np.testing.assert_allclose(tflat, jflat, **F64_TOL)
    assert taken == (["dense"] if n == 2047 else [])
    # the other path differs here: the switch decides the result
    other = tm(tg, t(x), lambda_max=1.9) if n == 2047 else None
    if other is not None:
        assert not np.allclose(other.detach().numpy(), tflat[:n * 4].reshape(
            n, 4), rtol=1e-3)


def test_dense_path_matches_jax_on_a_batch(monkeypatch):
    """The dense path on a batch of three directed graphs, λ fixed per
    graph on both sides: each graph's rows scaled by its own λ."""
    parts, off = [], 0
    for i, n in enumerate((30, 44, 26)):
        s, r = _bipartite(n, 4, seed=50 + i, directed=True)
        parts.append((s + off, r + off, n))
        off += n
    s = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    gid = np.repeat(np.arange(3), [p[2] for p in parts])
    jg, tg = _pair(s, r, off, node_graph_id=gid, num_graphs=3)
    rng = np.random.default_rng(53)
    x, cot = rng.standard_normal((off, 3)), rng.standard_normal((off, 2))
    _fix_lambda(monkeypatch, 1.8)
    jm, tm = _layers(3, 2, 4)
    jflat, tflat = _run(jm, tm, jg, tg, x, cot)
    np.testing.assert_allclose(tflat, jflat, **F64_TOL)


@pytest.mark.parametrize("per_graph", [False, True])
def test_lambda_given_on_a_batch_matches_jax(per_graph):
    """``lambda_max=`` as a scalar and as a per-graph ``[G]`` tensor (the
    matrix-free path on a small batch), forward and every gradient."""
    parts, off = [], 0
    for i, n in enumerate((20, 33, 17)):
        s, r = _bipartite(n, 4, seed=60 + i, directed=True)
        parts.append((s + off, r + off, n))
        off += n
    s = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    w = np.random.default_rng(61).random(len(s)) + 0.5
    gid = np.repeat(np.arange(3), [p[2] for p in parts])
    jg, tg = _pair(s, r, off, node_graph_id=gid, num_graphs=3,
                   edge_weight=w)
    rng = np.random.default_rng(62)
    x, cot = rng.standard_normal((off, 4)), rng.standard_normal((off, 3))
    lam = np.array([1.7, 1.95, 1.6]) if per_graph else 1.85
    jm, tm = _layers(4, 3, 3)
    jflat, tflat = _run(jm, tm, jg, tg, x, cot, lambda_max=lam)
    np.testing.assert_allclose(tflat, jflat, **F64_TOL)


# ---- λ from the power iterations --------------------------------------------

def _power_result(L, v0, products):
    """The exact result of a power iteration on the symmetric ``L`` from
    ``v0``: after ``products`` products the vector is ``sum_i c_i λ_i^p
    u_i`` (``c = U^T v0``), so the Rayleigh quotient the iteration returns
    is ``sum c_i^2 λ_i^(2p+1) / sum c_i^2 λ_i^(2p)``. Returns it and the
    exact λ_max; their gap is that start vector's convergence error."""
    lam, U = np.linalg.eigh(L)
    top = lam.max()
    c2 = (U.T @ v0) ** 2
    q = (lam / top) ** (2 * products)
    return float((c2 * q * lam).sum() / (c2 * q).sum()), float(top)


def _layer_tol(tm, tg, x, cot, lam, err):
    """``max |∂f/∂λ| * err``: how far the layer's output and gradients
    (``f``, flattened as :func:`_run` does) move when λ moves by ``err``,
    from a central difference of the port's layer with ``lambda_max=`` at
    ``lam ± h`` (the matrix-free path, equal to the dense one on a
    bidirected graph), doubled for the curvature over the step."""
    def f(lm):
        tx = t(x, grad=True)
        tm.zero_grad()
        y = tm(tg, tx, lambda_max=lm)
        (y * t(cot)).sum().backward()
        return np.concatenate([y.detach().numpy().ravel(),
                               tx.grad.numpy().ravel(),
                               tm.weight.grad.numpy().ravel(),
                               tm.bias.grad.numpy().ravel()])
    h = 1e-4
    slope = np.abs(f(lam + h) - f(lam - h)).max() / (2 * h)
    return 2.0 * slope * err


def _jax_start(shape):
    return np.asarray(jax.random.normal(jax.random.key(SEED), shape,
                                        jnp.float64))


@pytest.mark.parametrize("n", [2047, 2048])
def test_power_iteration_paths_match_jax_on_a_bidirected_graph(monkeypatch,
                                                                n):
    """Default ChebConv (no λ) on a bidirected graph at N = 2047 (dense:
    100 products) and 2048 (matrix-free: 50). Each side's λ equals the
    power-iteration result derived for its own start vector, and
    ``eigvalsh``'s λ_max within that result's error; the layers agree
    within the derived tolerance plus F64_TOL."""
    s, r = _bipartite(n, 32, seed=n + 1)
    jg, tg = _pair(s, r, n)
    L = tgnn.normalized_laplacian(tg, dtype=torch.float64).numpy()
    dense = n == 2047
    p = 100 if dense else 50
    if dense:
        tv0 = TQ.start_vector((n,), torch.float64, "cpu").numpy()
        jv0 = _jax_start((jg.n_pad,))[:n]
        t_lam = float(tgnn.laplacian_lambda_max(tg, dtype=torch.float64))
        j_lam = float(jgnn.laplacian_lambda_max(jg, dtype=jnp.float64))
    else:
        tv0 = TQ.start_vector((n, 1), torch.float64, "cpu").numpy()[:, 0]
        jv0 = _jax_start((jg.n_pad, 1))[:n, 0]
        t_lam = float(TM.cheb_lambda_max(tg, torch.float64)[0])
        j_lam = float(jconv.cheb_lambda_max(jg, jnp.float64)[0])
    t_want, top = _power_result(L, tv0, p)
    j_want, _ = _power_result(L, jv0, p)
    assert abs(top - np.linalg.eigvalsh(L).max()) < POWER_ROUNDING
    for got, want in ((t_lam, t_want), (j_lam, j_want)):
        assert abs(got - want) <= POWER_ROUNDING
        assert abs(got - top) <= abs(want - top) + POWER_ROUNDING
    err = abs(t_want - top) + abs(j_want - top) + 2 * POWER_ROUNDING
    assert err < 1e-8, "the iteration has not converged on this graph"
    rng = np.random.default_rng(n + 2)
    x, cot = rng.standard_normal((n, 3)), rng.standard_normal((n, 2))
    jm, tm = _layers(3, 2, 3, seed=1)
    taken = []
    monkeypatch.setattr(tconv, "scaled_laplacian",
                        lambda *a, **k: taken.append(1)
                        or TQ.scaled_laplacian(*a, **k))
    jflat, tflat = _run(jm, tm, jg, tg, x, cot)
    assert bool(taken) is dense
    tol = _layer_tol(tm, tg, x, cot, top, err)
    np.testing.assert_allclose(tflat, jflat, rtol=F64_TOL["rtol"],
                               atol=F64_TOL["atol"] + tol)


def test_per_graph_lambda_max_matches_eigvalsh_and_jax():
    """A batch of three bidirected graphs: ``laplacian_lambda_max`` (dense,
    100 products) and ``cheb_lambda_max`` (matrix-free, 50), both sides,
    each graph held to the result derived for its own start column, and
    the default ChebConv on the batch (dense path) to JAX within the
    derived tolerance."""
    parts, off = [], 0
    rng = np.random.default_rng(71)
    for i, n in enumerate((40, 64, 50)):
        s, r = _bipartite(n, 16, seed=70 + i)
        w = rng.random(len(s) // 2) + 0.5      # one weight per pair
        parts.append((s + off, r + off, n, off, np.concatenate([w, w])))
        off += n
    s = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    w = np.concatenate([p[4] for p in parts])
    gid = np.repeat(np.arange(3), [p[2] for p in parts])
    jg, tg = _pair(s, r, off, node_graph_id=gid, num_graphs=3,
                   edge_weight=w)
    L = tgnn.normalized_laplacian(tg, dtype=torch.float64).numpy()
    np.testing.assert_allclose(L, L.T, rtol=0, atol=1e-15)
    got = {"dense": (tgnn.laplacian_lambda_max(tg, dtype=torch.float64),
                     jgnn.laplacian_lambda_max(jg, dtype=jnp.float64), 100),
           "matrix_free": (TM.cheb_lambda_max(tg, torch.float64),
                           jconv.cheb_lambda_max(jg, jnp.float64), 50)}
    tv0 = TQ.start_vector((off, 3), torch.float64, "cpu").numpy()
    jv0 = _jax_start((jg.n_pad, jg.g_pad))
    err = 0.0
    for t_lam, j_lam, p in got.values():
        assert t_lam.shape == (3,)
        for b, (_, _, n, o, _) in enumerate(parts):
            block = L[o:o + n, o:o + n]
            t_want, top = _power_result(block, tv0[o:o + n, b], p)
            j_want, _ = _power_result(block, jv0[o:o + n, b], p)
            for lam, want in ((float(t_lam[b]), t_want),
                              (float(j_lam[b]), j_want)):
                assert abs(lam - want) <= POWER_ROUNDING
                assert abs(lam - top) <= abs(want - top) + POWER_ROUNDING
            if p == 100:
                err = max(err, abs(t_want - top) + abs(j_want - top))
    err += 2 * POWER_ROUNDING
    assert err < 1e-8, "the iteration has not converged on these graphs"
    rng = np.random.default_rng(72)
    x, cot = rng.standard_normal((off, 4)), rng.standard_normal((off, 3))
    jm, tm = _layers(4, 3, 3, seed=2)
    jflat, tflat = _run(jm, tm, jg, tg, x, cot)
    lam = tgnn.laplacian_lambda_max(tg, dtype=torch.float64)
    tol = _layer_tol(tm, tg, x, cot, lam, err)
    np.testing.assert_allclose(tflat, jflat, rtol=F64_TOL["rtol"],
                               atol=F64_TOL["atol"] + tol)


def test_start_vector_is_the_same_on_every_device():
    """Drawn in float64 from a CPU generator, then cast and moved: the
    float32 vector is the float64 one rounded, on any device."""
    a = TQ.start_vector((50, 3), torch.float64, "cpu")
    b = TQ.start_vector((50, 3), torch.float32, "cpu")
    torch.testing.assert_close(b, a.float(), rtol=0, atol=0)
    want = torch.randn((50, 3), generator=torch.Generator().manual_seed(SEED),
                       dtype=torch.float64)
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    meta = TQ.start_vector((50, 3), torch.float32, "meta")
    assert meta.device.type == "meta" and meta.shape == (50, 3)

