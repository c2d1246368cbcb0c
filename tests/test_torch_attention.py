"""Port's attention (ops/attention.py, ops/cuda/edge_softmax.py) vs JAX.

``attention_aggregate`` (edge and node values, 1 and 2 heads, with and
without the virtual self-loop, with and without numpy-made dropout masks),
``gat_attention`` and ``gatv2_attention`` (1, 2 and 4 heads, with and
without the self-loop; GATv2 also with dropout masks): the forward and the
gradient of every input, against

- the JAX XLA path (graphs without ``build_spmm_aux``), float64 on both
  sides: only summation order differs, rtol 1e-9, atol 1e-10;
- the JAX Pallas path (``build_spmm_aux=True``: K3, K4, K5 and K12, or K9,
  K10 and K11, in interpret mode), float32, at the JAX package's kernel
  tolerances (forward 1e-5, gradients rtol 1e-4 / atol 1e-5; GATv2's
  forward 2e-5, gradients rtol 2e-4 / atol 3e-5, as its own tests hold its
  kernels to its XLA path).

The port is run by two routes on the CPU: ``plain`` is what a CPU tensor
takes (the counterpart of the XLA path), ``kernels`` sends the same CPU
tensors through the autograd functions the card uses, whose kernels fall
back to their plain versions only because the tensors lie on the CPU.
``torch.autograd.gradcheck`` checks each of those functions in float64.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from torch_parity import F64_TOL, directed_graph_arrays, graph_pair  # noqa: E402

PALLAS_FWD = dict(rtol=1e-5, atol=1e-5)
PALLAS_GRAD = dict(rtol=1e-4, atol=1e-5)
# tests/test_pallas_edge_softmax.py::test_gatv2_kernel_matches_xla
PALLAS_V2_FWD = dict(rtol=2e-5, atol=2e-5)
PALLAS_V2_GRAD = dict(rtol=2e-4, atol=3e-5)
SLOPE = 0.2
D = 3
O = 5     # GATv2's per-head width


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    return request.param


def _graph(aux, dtype):
    """50 nodes, the last 10 without edges; 160 directed edges."""
    s, r, n, _ = directed_graph_arrays(seed=5)
    jg, tg = graph_pair(s, r, n, aux=aux, dtype=dtype)
    return jg, tg, n, len(s)


def _masks(rng, jg, heads, with_self):
    keep = 0.6
    me = (rng.random((jg.e_pad, heads)) < keep) / keep
    ms = (rng.random((jg.n_pad, heads)) < keep) / keep if with_self else None
    return me, ms


def _compare(jax_fn, port_fn, inputs, rows, cot, dtype, fwd_tol, grad_tol):
    """Forward and the gradient of every input of ``sum(out * cot)``.

    ``inputs``: numpy arrays at JAX's padded sizes (None: absent);
    ``rows[i]`` is how many leading rows of input i the port takes.
    """
    n = cot.shape[0]
    present = [i for i, a in enumerate(inputs) if a is not None]
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def jloss(*xs):
        args = list(inputs)
        for i, x in zip(present, xs):
            args[i] = x
        out = jax_fn(*args)[:n]
        return jnp.sum(out * jnp.asarray(cot, jdt)), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(present))), has_aux=True)(
        *[jnp.asarray(inputs[i], jdt) for i in present])
    targs = [None if a is None else
             torch.tensor(np.asarray(a[:k], dtype), dtype=tdt,
                          requires_grad=True)
             for a, k in zip(inputs, rows)]
    tout = port_fn(*targs)
    (tout * torch.tensor(cot, dtype=tdt)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **fwd_tol)
    for i, jgrad in zip(present, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(),
                                   np.asarray(jgrad)[:rows[i]],
                                   err_msg=f"input {i}", **grad_tol)


def _run_aggregate(aux, dtype, heads, node_values, with_self, dropout,
                   fwd_tol, grad_tol):
    jg, tg, n, ne = _graph(aux, dtype)
    rng = np.random.default_rng(heads + 2 * node_values + 4 * with_self)
    v_rows = jg.n_pad if node_values else jg.e_pad
    shape_h = (heads,) if heads > 1 else ()     # heads == 1: squeezed
    lg = rng.standard_normal((jg.e_pad,) + shape_h)
    v = rng.standard_normal((v_rows,) + shape_h + (D,))
    sl = rng.standard_normal((jg.n_pad,) + shape_h) if with_self else None
    sv = (rng.standard_normal((jg.n_pad,) + shape_h + (D,))
          if with_self else None)
    me = ms = None
    if dropout:
        me, ms = _masks(rng, jg, heads, with_self)
        if heads == 1:
            me, ms = me[:, 0], None if ms is None else ms[:, 0]
    cot = rng.standard_normal((n,) + shape_h + (D,))
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jdm = (None if me is None else
           (jnp.asarray(me, jdt), None if ms is None else jnp.asarray(ms, jdt)))
    tdm = (None if me is None else
           (torch.tensor(me[:ne], dtype=tdt),
            None if ms is None else torch.tensor(ms[:n], dtype=tdt)))

    def jax_fn(a, b, c, d):
        return JA.attention_aggregate(jg, a, b, self_logits=c, self_values=d,
                                      dropout_masks=jdm,
                                      node_values=node_values)

    def port_fn(a, b, c, d):
        return TA.attention_aggregate(tg, a, b, self_logits=c, self_values=d,
                                      dropout_masks=tdm,
                                      node_values=node_values)

    _compare(jax_fn, port_fn, [lg, v, sl, sv],
             [ne, n if node_values else ne, n, n], cot, dtype, fwd_tol,
             grad_tol)


def _run_gat(aux, dtype, heads, with_self, fwd_tol, grad_tol):
    jg, tg, n, _ = _graph(aux, dtype)
    rng = np.random.default_rng(10 + heads + 8 * with_self)
    pi = rng.standard_normal((jg.n_pad, heads))
    pj = rng.standard_normal((jg.n_pad, heads))
    v = rng.standard_normal((jg.n_pad, heads, D))
    sl = rng.standard_normal((jg.n_pad, heads)) if with_self else None
    sv = rng.standard_normal((jg.n_pad, heads, D)) if with_self else None
    cot = rng.standard_normal((n, heads, D))

    def jax_fn(a, b, c, d, e):
        return JA.gat_attention(jg, a, b, c, SLOPE, self_logits=d,
                                self_values=e)

    def port_fn(a, b, c, d, e):
        return TA.gat_attention(tg, a, b, c, SLOPE, self_logits=d,
                                self_values=e)

    _compare(jax_fn, port_fn, [pi, pj, v, sl, sv], [n] * 5, cot, dtype,
             fwd_tol, grad_tol)


def _run_gatv2(aux, dtype, heads, with_self, fwd_tol, grad_tol,
               dropout=False):
    """``gatv2_attention``: the gradients of q, k, a and the self-loop
    terms; with ``dropout``, numpy-made masks (the gathered route)."""
    jg, tg, n, ne = _graph(aux, dtype)
    rng = np.random.default_rng(20 + heads + 8 * with_self + 16 * dropout)
    q = rng.standard_normal((jg.n_pad, heads, O))
    k = rng.standard_normal((jg.n_pad, heads, O))
    a = rng.standard_normal((O, heads))
    sl = rng.standard_normal((jg.n_pad, heads)) if with_self else None
    sv = rng.standard_normal((jg.n_pad, heads, O)) if with_self else None
    cot = rng.standard_normal((n, heads, O))
    jdm = tdm = None
    if dropout:
        me, ms = _masks(rng, jg, heads, with_self)
        jdt = jnp.float64 if dtype == np.float64 else jnp.float32
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        jdm = (jnp.asarray(me, jdt),
               None if ms is None else jnp.asarray(ms, jdt))
        tdm = (torch.tensor(me[:ne], dtype=tdt),
               None if ms is None else torch.tensor(ms[:n], dtype=tdt))

    def jax_fn(q_, k_, a_, sl_, sv_):
        return JA.gatv2_attention(jg, q_, k_, a_, SLOPE, self_logits=sl_,
                                  self_values=sv_, dropout_masks=jdm)

    def port_fn(q_, k_, a_, sl_, sv_):
        return TA.gatv2_attention(tg, q_, k_, a_, SLOPE, self_logits=sl_,
                                  self_values=sv_, dropout_masks=tdm)

    _compare(jax_fn, port_fn, [q, k, a, sl, sv], [n, n, O, n, n], cot, dtype,
             fwd_tol, grad_tol)


AGG = [(h, nv, ws, dr) for h in (1, 2) for nv in (False, True)
       for ws in (False, True) for dr in (False, True)]
AGG_IDS = [f"h{h}-{'node' if nv else 'edge'}-{'self' if ws else 'noself'}-"
           f"{'drop' if dr else 'nodrop'}" for h, nv, ws, dr in AGG]


@pytest.mark.parametrize("heads,node_values,with_self,dropout", AGG,
                         ids=AGG_IDS)
def test_attention_aggregate_matches_xla_f64(route, heads, node_values,
                                             with_self, dropout):
    _run_aggregate(False, np.float64, heads, node_values, with_self, dropout,
                   F64_TOL, F64_TOL)


@pytest.mark.parametrize("heads,node_values,with_self,dropout", AGG,
                         ids=AGG_IDS)
def test_attention_aggregate_matches_pallas_f32(monkeypatch, heads,
                                                node_values, with_self,
                                                dropout):
    monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    _run_aggregate(True, np.float32, heads, node_values, with_self, dropout,
                   PALLAS_FWD, PALLAS_GRAD)


@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_gat_attention_matches_xla_f64(route, heads, with_self):
    _run_gat(False, np.float64, heads, with_self, F64_TOL, F64_TOL)


@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_gat_attention_matches_pallas_f32(monkeypatch, heads, with_self):
    monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    _run_gat(True, np.float32, heads, with_self, PALLAS_FWD, PALLAS_GRAD)


@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_gatv2_attention_matches_xla_f64(route, heads, with_self):
    _run_gatv2(False, np.float64, heads, with_self, F64_TOL, F64_TOL)


@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_gatv2_attention_matches_pallas_f32(monkeypatch, heads, with_self):
    monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    _run_gatv2(True, np.float32, heads, with_self, PALLAS_V2_FWD,
               PALLAS_V2_GRAD)


@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 4])
def test_gatv2_attention_dropout_matches_xla_f64(route, heads, with_self):
    """With dropout masks both routes take the gathered logits and K12's
    autograd function (on the card: K12, and K2 per head backward)."""
    _run_gatv2(False, np.float64, heads, with_self, F64_TOL, F64_TOL,
               dropout=True)


# ---- the autograd functions in float64 -------------------------------------

def _small(seed=0, heads=2):
    rng = np.random.default_rng(seed)
    s, r, n, _ = directed_graph_arrays(seed=seed, n=20, n_active=16, e=60)
    g = tgnn.graph(s, r, num_nodes=n, device="cpu")

    def x(*shape):
        return torch.tensor(rng.standard_normal(shape), requires_grad=True)

    def mask(*shape):
        return torch.tensor((rng.random(shape) < 0.6) / 0.6)

    return g, n, len(s), x, mask


@pytest.mark.parametrize("with_self", [False, True])
def test_gat_attention_function_gradcheck(with_self):
    g, n, _, x, _ = _small(1)
    args = [x(n, 2), x(n, 2), x(n, 2, 3)]
    if with_self:
        args += [x(n, 2), x(n, 2, 3)]

    def f(pi, pj, v, sl=None, sv=None):
        return ES.gat_attention_nodes(g, pi, pj, v, SLOPE, self_logits=sl,
                                      self_values=sv)

    assert torch.autograd.gradcheck(f, tuple(args))


@pytest.mark.parametrize("with_self", [False, True])
def test_gatv2_attention_function_gradcheck(with_self):
    g, n, _, x, _ = _small(7)
    args = [x(n, 2, 3), x(n, 2, 3), x(3, 2)]
    if with_self:
        args += [x(n, 2), x(n, 2, 3)]

    def f(q, k, a, sl=None, sv=None):
        return ES.gatv2_attention_nodes(g, q, k, a, SLOPE, self_logits=sl,
                                        self_values=sv)

    assert torch.autograd.gradcheck(f, tuple(args))


@pytest.mark.parametrize("node_values", [False, True])
@pytest.mark.parametrize("with_self,dropout",
                         [(False, False), (True, False), (True, True)])
def test_edge_softmax_functions_gradcheck(node_values, with_self, dropout):
    g, n, ne, x, mask = _small(2)
    fn = (ES.edge_softmax_aggregate_nodes if node_values
          else ES.edge_softmax_aggregate)
    args = [x(ne, 2), x(n if node_values else ne, 2, 3)]
    if with_self:
        args += [x(n, 2), x(n, 2, 3)]
    dm = (mask(ne, 2), mask(n, 2) if with_self else None) if dropout else None

    def f(lg, v, sl=None, sv=None):
        return fn(g, lg, v, self_logits=sl, self_values=sv, dropout_masks=dm)

    assert torch.autograd.gradcheck(f, tuple(args))


def test_bipartite_gat_attention_kernels_match_plain(monkeypatch):
    """Fewer receivers than nodes (``num_segments``) and fewer senders than
    nodes: the kernel route cuts both CSRs as the plain path reads them."""
    rng = np.random.default_rng(3)
    s, r = rng.integers(0, 30, 120), rng.integers(0, 20, 120)
    g = tgnn.graph(s, r, num_nodes=30, device="cpu")

    def x(*shape):
        return torch.tensor(rng.standard_normal(shape), requires_grad=True)

    pi, pj, v, sl, sv = x(20, 2), x(30, 2), x(30, 2, 3), x(20, 2), x(20, 2, 3)
    cot = torch.tensor(rng.standard_normal((20, 2, 3)))
    results = []
    for kernels in (False, True):
        monkeypatch.setattr(TA, "_kernel_route", lambda t, k=kernels: k)
        for t in (pi, pj, v, sl, sv):
            t.grad = None
        out = TA.gat_attention(g, pi, pj, v, SLOPE, self_logits=sl,
                               self_values=sv, num_segments=20)
        (out * cot).sum().backward()
        results.append([out.detach()] + [t.grad for t in (pi, pj, v, sl, sv)])
    for a, b in zip(*results):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F64_TOL)


def test_isolated_rows_and_finalize_guards():
    """A node with no in-edges and no self-loop gets 0 (mx = 0, den =
    tiny); with a self-loop, its own value."""
    g = tgnn.graph([0, 1], [1, 0], num_nodes=3, device="cpu")
    lg = torch.zeros(2, 1, dtype=torch.float64)
    v = torch.arange(6, dtype=torch.float64).reshape(3, 1, 2)
    num, m, s = ES.edge_softmax_plain(g.indptr_r, g.col_r, lg, None, v)
    assert torch.isneginf(m[2]).all() and s[2].item() == 0.0
    out, mx, den = ES.finalize_softmax(num, m, s)
    assert mx[2].item() == 0.0
    assert den[2].item() == torch.finfo(torch.float64).tiny
    np.testing.assert_array_equal(out[2].numpy(), 0.0)
    sl = torch.zeros(3, 1, dtype=torch.float64)
    out, _, _ = ES.finalize_softmax(num, m, s, sl, v)
    np.testing.assert_allclose(out[2].numpy(), v[2].numpy())
    np.testing.assert_allclose(out[0].numpy(), (v[0] + v[1]).numpy() / 2)


def test_leaky_relu_slope_at_zero_is_one():
    """jax.nn.leaky_relu differentiates raw == 0 with slope 1;
    torch.nn.functional.leaky_relu would give the negative slope."""
    raw = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    ES.lrelu(raw, SLOPE).sum().backward()
    np.testing.assert_array_equal(raw.grad.numpy(), 1.0)
    jgrad = jax.grad(lambda a: jnp.sum(jax.nn.leaky_relu(a, SLOPE)))(
        jnp.zeros(3))
    np.testing.assert_array_equal(np.asarray(jgrad), 1.0)
    np.testing.assert_array_equal(
        ES._dlrelu(torch.tensor([-1.0, 0.0, 2.0]), SLOPE).numpy(),
        np.float32([SLOPE, 1.0, 1.0]))


def test_cpu_tensors_launch_nothing(route):
    g, n, ne, x, mask = _small(4)
    before = dict(ES.launches)
    out = TA.gat_attention(g, x(n, 2), x(n, 2), x(n, 2, 3), SLOPE)
    out.sum().backward()
    out = TA.attention_aggregate(g, x(ne, 2), x(n, 2, 3), node_values=True,
                                 dropout_masks=(mask(ne, 2), None))
    out.sum().backward()
    for dm in (None, (mask(ne, 2), mask(n, 2))):
        out = TA.gatv2_attention(g, x(n, 2, 3), x(n, 2, 3), x(3, 2), SLOPE,
                                 self_logits=x(n, 2), self_values=x(n, 2, 3),
                                 dropout_masks=dm)
        out.sum().backward()
    assert ES.launches == before


def test_several_head_dims_kernels_match_plain(monkeypatch):
    """``[E, *H]`` with two head dimensions: the kernel route flattens them
    into one for K12 and gives the plain path's forward and gradients."""
    g, n, ne, x, mask = _small(5)
    rng = np.random.default_rng(5)
    shapes = [(ne, 2, 3), (n, 2, 3, 4), (n, 2, 3), (n, 2, 3, 4)]
    inputs = [torch.tensor(rng.standard_normal(s)) for s in shapes]
    dm = (mask(ne, 2, 3), mask(n, 2, 3))
    cot = torch.tensor(rng.standard_normal((n, 2, 3, 4)))
    results = []
    for kernels in (False, True):
        monkeypatch.setattr(TA, "_kernel_route", lambda t, k=kernels: k)
        ts = [a.clone().requires_grad_() for a in inputs]
        out = TA.attention_aggregate(g, ts[0], ts[1], self_logits=ts[2],
                                     self_values=ts[3], dropout_masks=dm,
                                     node_values=True)
        (out * cot).sum().backward()
        results.append([out.detach()] + [t.grad for t in ts])
    assert results[1][0].shape == (n, 2, 3, 4)
    for a, b in zip(*results):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F64_TOL)


def test_rank_mismatch_raises(route):
    g, n, ne, x, _ = _small(6)
    with pytest.raises(ValueError, match="one more dimension"):
        TA.attention_aggregate(g, x(ne, 2), x(n, 2), node_values=True)


@pytest.mark.parametrize("side", ["receiver", "sender"])
def test_rows_past_the_cut_raise(side):
    """A receiver at or past ``num_segments`` (or a sender at or past the
    node values' rows) would have the card read past the per-node state:
    the entry points refuse it before any kernel runs."""
    g = tgnn.graph([0, 1, 2, 3], [3, 0, 1, 2], num_nodes=4, device="cpu")
    pi, pj, v = torch.zeros(4, 1), torch.zeros(4, 1), torch.zeros(4, 1, 2)
    lg, a = torch.zeros(4, 1), torch.zeros(2, 1)
    if side == "receiver":
        pi = pi[:3]
        calls = [lambda: ES.gat_attention_nodes(g, pi, pj, v, SLOPE),
                 lambda: ES.gatv2_attention_nodes(g, v[:3], v, a, SLOPE),
                 lambda: ES.edge_softmax_aggregate_nodes(g, lg, v,
                                                         num_segments=3),
                 lambda: ES.edge_softmax_aggregate(g, lg, torch.zeros(4, 1, 2),
                                                   num_segments=3)]
    else:
        pj, v = pj[:3], v[:3]
        calls = [lambda: ES.gat_attention_nodes(g, pi, pj, v, SLOPE),
                 lambda: ES.gatv2_attention_nodes(
                     g, torch.zeros(4, 1, 2), v, a, SLOPE),
                 lambda: ES.edge_softmax_aggregate_nodes(g, lg, v)]
    for call in calls:
        with pytest.raises(ValueError, match=f"a {side} at or past"):
            call()
    # every edge inside the cut: accepted
    g2 = tgnn.graph([0, 1, 2], [1, 0, 2], num_nodes=4, device="cpu")
    out = ES.gat_attention_nodes(g2, torch.zeros(3, 1), torch.zeros(3, 1),
                                 torch.ones(3, 1, 2), SLOPE)
    np.testing.assert_allclose(out.numpy(), 1.0)


def test_bipartite_gatv2_attention_kernels_match_plain(monkeypatch):
    """20 receivers (``num_segments``) of 30 nodes: the kernel route cuts
    the receiver CSR to q's rows and the sender CSR to k's."""
    rng = np.random.default_rng(8)
    s, r = rng.integers(0, 30, 120), rng.integers(0, 20, 120)
    g = tgnn.graph(s, r, num_nodes=30, device="cpu")

    def x(*shape):
        return torch.tensor(rng.standard_normal(shape), requires_grad=True)

    ins = [x(20, 2, 3), x(30, 2, 3), x(3, 2), x(20, 2), x(20, 2, 3)]
    cot = torch.tensor(rng.standard_normal((20, 2, 3)))
    results = []
    for kernels in (False, True):
        monkeypatch.setattr(TA, "_kernel_route", lambda t, k=kernels: k)
        for t in ins:
            t.grad = None
        out = TA.gatv2_attention(g, *ins[:3], SLOPE, self_logits=ins[3],
                                 self_values=ins[4], num_segments=20)
        (out * cot).sum().backward()
        results.append([out.detach()] + [t.grad for t in ins])
    for a, b in zip(*results):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F64_TOL)


def test_gatv2_backward_computes_only_what_is_needed(monkeypatch):
    """``needs_input_grad``: with only ``k`` requiring a gradient the
    receiver-side sweep (K10) is skipped, and with only ``q`` the sender
    side (K11)."""
    g, n, _, x, _ = _small(9)
    calls = []
    for name in ("gatv2_bwd_dq", "gatv2_bwd_rev"):
        fn = getattr(ES, name)
        monkeypatch.setattr(ES, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    for grad_of, want in ((1, ["gatv2_bwd_rev"]), (0, ["gatv2_bwd_dq"]),
                          (2, ["gatv2_bwd_dq"])):
        ins = [x(n, 2, 3).detach(), x(n, 2, 3).detach(), x(3, 2).detach()]
        ins[grad_of].requires_grad_()
        calls.clear()
        ES.gatv2_attention_nodes(g, *ins, SLOPE).sum().backward()
        assert calls == want
        assert all((t.grad is not None) == (i == grad_of)
                   for i, t in enumerate(ins))


