"""Port's dot attention and per-edge dots vs JAX: ``dot_attention``,
``dot_attention_nodes`` (K6, K7, K8), ``dot_attention_logits`` and
``apply_edges(xi_dot_xj)`` (K13).

The forward and the gradient of every input, against

- the JAX XLA path (graphs without ``build_spmm_aux``), float64 on both
  sides: only summation order differs, rtol 1e-9, atol 1e-10. With a
  ``slope`` the JAX reference is its own composition, gathered dots through
  ``jax.nn.leaky_relu`` then ``attention_aggregate``, since JAX's public
  ``dot_attention`` has no slope;
- the JAX Pallas path (``build_spmm_aux=True``: K6, K7 and K8 in interpret
  mode; K13 at a width above its 256 gate), float32. That path casts ``q``
  and its softmax state to float32 (edge_softmax.py:520-521, 384-386, 711)
  and sums in other orders, so it is held to the JAX package's own tolerance
  between its dot kernels and its XLA path
  (tests/test_pallas_edge_softmax.py:334-340): forward 2e-5, gradients
  rtol 2e-4 / atol 2e-5.

The port runs by two routes on the CPU: ``plain`` is what a CPU tensor
takes, ``kernels`` sends the same CPU tensors through the autograd
functions the card uses (``DotAttentionFunction``, ``SddmmFunction``),
whose kernels fall back to their plain versions only because the tensors
lie on the CPU. ``torch.autograd.gradcheck`` checks both functions in
float64 on a 20-node graph.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import msgpass as TMP  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD  # noqa: E402
from test_torch_attention import _compare, _graph  # noqa: E402
from torch_parity import F64_TOL, directed_graph_arrays, graph_pair  # noqa: E402

PALLAS_FWD = dict(rtol=2e-5, atol=2e-5)
PALLAS_GRAD = dict(rtol=2e-4, atol=2e-5)
O, D, SCALE = 6, 4, 0.37    # tests/test_pallas_edge_softmax.py:313


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
        monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    return request.param


def _jax_dot_slope(jg, slope):
    """JAX's XLA composition of dot attention with a leaky_relu on the
    scaled logits: what ``dot_attention_nodes`` computes with a slope."""
    def fn(q, k, v, sl, sv):
        lg = jax.nn.leaky_relu(JA.dot_attention_logits(jg, q, k) * SCALE,
                               slope)
        return JA.attention_aggregate(jg, lg, v, self_logits=sl,
                                      self_values=sv, node_values=True)
    return fn


def _jax_dot_nodes_pallas(jg, slope):
    """JAX's fused dot attention (K6-K8 in interpret mode) with a slope."""
    from graphneuralnetworks_tpu.ops.pallas.edge_softmax import \
        dot_attention_nodes

    def fn(q, k, v, sl, sv):
        return dot_attention_nodes(
            q, k, v, jg.spmm_aux, (jg.receivers, jg.senders, jg.edge_mask),
            (jg.n_pad, v.shape[0], SCALE, slope), sl, sv)
    return fn


def _run_dot(aux, dtype, heads, with_self, slope, fwd_tol, grad_tol):
    """``dot_attention`` (slope None) or ``dot_attention_nodes`` (a slope):
    the gradients of q, k, the values and the self-loop terms."""
    jg, tg, n, _ = _graph(aux, dtype)
    rng = np.random.default_rng(30 + heads + 4 * with_self + 8 * (slope
                                                                  is None))
    q = rng.standard_normal((jg.n_pad, heads, O))
    k = rng.standard_normal((jg.n_pad, heads, O))
    v = rng.standard_normal((jg.n_pad, heads, D))
    sl = rng.standard_normal((jg.n_pad, heads)) if with_self else None
    sv = rng.standard_normal((jg.n_pad, heads, D)) if with_self else None
    cot = rng.standard_normal((n, heads, D))
    if slope is None:
        def jax_fn(q_, k_, v_, sl_, sv_):
            return JA.dot_attention(jg, q_, k_, v_, SCALE, self_logits=sl_,
                                    self_values=sv_)

        def port_fn(q_, k_, v_, sl_, sv_):
            return TA.dot_attention(tg, q_, k_, v_, SCALE, self_logits=sl_,
                                    self_values=sv_)
    else:
        jax_fn = (_jax_dot_nodes_pallas if aux else _jax_dot_slope)(jg, slope)

        def port_fn(q_, k_, v_, sl_, sv_):
            return ES.dot_attention_nodes(tg, q_, k_, v_, SCALE, slope,
                                          self_logits=sl_, self_values=sv_)
    _compare(jax_fn, port_fn, [q, k, v, sl, sv], [n] * 5, cot, dtype,
             fwd_tol, grad_tol)


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_dot_attention_matches_xla_f64(route, heads, with_self, slope):
    _run_dot(False, np.float64, heads, with_self, slope, F64_TOL, F64_TOL)


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("with_self", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_dot_attention_matches_pallas_f32(monkeypatch, heads, with_self,
                                          slope):
    monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    _run_dot(True, np.float32, heads, with_self, slope, PALLAS_FWD,
             PALLAS_GRAD)


@pytest.mark.parametrize("heads", [None, 2])
def test_dot_attention_logits_matches_xla_f64(route, heads):
    """``[N, O] -> [E]`` (``heads=None``) and ``[N, H, O] -> [E, H]``, and
    the gradients of both inputs."""
    jg, tg, n, ne = _graph(False, np.float64)
    rng = np.random.default_rng(40 + (heads or 0))
    shape = (jg.n_pad,) + ((heads,) if heads else ()) + (O,)
    qi, kj = rng.standard_normal(shape), rng.standard_normal(shape)
    cot = rng.standard_normal((ne,) + ((heads,) if heads else ()))

    def jloss(a, b):
        out = JA.dot_attention_logits(jg, a, b)[:ne]
        return jnp.sum(out * cot), out

    (_, jout), (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(qi), jnp.asarray(kj))
    a = torch.tensor(qi[:n], requires_grad=True)
    b = torch.tensor(kj[:n], requires_grad=True)
    out = TA.dot_attention_logits(tg, a, b)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **F64_TOL)
    for got, want in ((a, ga), (b, gb)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want)[:n],
                                   **F64_TOL)


def _run_apply_edges_dot(aux, dtype, width, tol, same_x=False):
    """``apply_edges(xi_dot_xj)`` of two node matrices (or of one, as
    ``DotDecoder`` calls it) -> ``[E, 1]``, and the input gradients."""
    s, r, n, _ = directed_graph_arrays(seed=5)
    jg, tg = graph_pair(s, r, n, aux=aux, dtype=dtype)
    ne = len(s)
    rng = np.random.default_rng(50 + width)
    xi = rng.standard_normal((jg.n_pad, width)).astype(dtype)
    xj = xi if same_x else rng.standard_normal((jg.n_pad, width)).astype(dtype)
    cot = rng.standard_normal((ne, 1)).astype(dtype)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def jloss(a, b):
        out = jops.apply_edges(jops.xi_dot_xj, jg, xi=a,
                               xj=a if same_x else b)[:ne]
        return jnp.sum(out * cot), out

    (_, jout), (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(xi, jdt), jnp.asarray(xj, jdt))
    a = torch.tensor(xi[:n], dtype=tdt, requires_grad=True)
    b = a if same_x else torch.tensor(xj[:n], dtype=tdt, requires_grad=True)
    out = tops.apply_edges(tops.xi_dot_xj, tg, xi=a, xj=b)
    assert out.shape == (ne, 1)
    (out * torch.tensor(cot, dtype=tdt)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga)[:n], **tol)
    if not same_x:
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb)[:n], **tol)


@pytest.mark.parametrize("same_x", [False, True])
def test_apply_edges_xi_dot_xj_matches_xla_f64(route, same_x):
    _run_apply_edges_dot(False, np.float64, 5, F64_TOL, same_x)


def test_apply_edges_xi_dot_xj_matches_pallas_sddmm_f32(monkeypatch):
    """D = 260 > 256: the JAX side takes its SDDMM kernel (K13, interpret
    mode) with two K1 calls backward."""
    monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    _run_apply_edges_dot(True, np.float32, 260,
                         dict(rtol=2e-5, atol=2e-4))


def test_apply_edges_takes_sddmm_only_for_node_matrices(monkeypatch):
    """The SDDMM route needs ``xi_dot_xj``, two ``[num_nodes, D]`` tensors
    and no edge features; every other case gathers as before."""
    _, tg, n, ne = _graph(False, np.float64)
    calls = []
    monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    monkeypatch.setattr(TMP, "sddmm",
                        lambda *a: calls.append(1) or SD.sddmm(*a))
    x2 = torch.randn(n, 3, dtype=torch.float64)
    x3 = torch.randn(n, 2, 3, dtype=torch.float64)
    tops.apply_edges(tops.xi_dot_xj, tg, xi=x2, xj=x2)
    assert calls == [1]
    tops.apply_edges(tops.xi_dot_xj, tg, xi=x3, xj=x3)
    tops.apply_edges(tops.xi_dot_xj, tg, xi=x2, xj=x2, e=torch.ones(ne))
    tops.apply_edges(tops.xi_dot_xj, tg, xi=x2, xj=x2[: n - 1])
    tops.apply_edges(tops.xi_sub_xj, tg, xi=x2, xj=x2)
    assert calls == [1]


# ---- the autograd functions in float64 -------------------------------------

def _small(seed):
    rng = np.random.default_rng(seed)
    s, r, n, _ = directed_graph_arrays(seed=seed, n=20, n_active=16, e=60)
    g = tgnn.graph(s, r, num_nodes=n, device="cpu")

    def x(*shape):
        return torch.tensor(rng.standard_normal(shape), requires_grad=True)

    return g, n, x


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("with_self", [False, True])
def test_dot_attention_function_gradcheck(with_self, slope):
    g, n, x = _small(21)
    args = [x(n, 2, 3), x(n, 2, 3), x(n, 2, 4)]
    if with_self:
        args += [x(n, 2), x(n, 2, 4)]

    def f(q, k, v, sl=None, sv=None):
        return ES.dot_attention_nodes(g, q, k, v, SCALE, slope,
                                      self_logits=sl, self_values=sv)

    assert torch.autograd.gradcheck(f, tuple(args))


@pytest.mark.parametrize("heads", [None, 3])
def test_sddmm_function_gradcheck(heads):
    g, n, x = _small(22)
    shape = (n,) + ((heads,) if heads else ()) + (4,)
    assert torch.autograd.gradcheck(lambda a, b: SD.sddmm(g, a, b),
                                    (x(*shape), x(*shape)))


def test_dot_kernel_route_flattens_head_dims(monkeypatch):
    """``[N, *H, O]`` with no or two head dimensions: the kernel route
    flattens them into one for K6-K8 and K13 and gives the plain path's
    forward and gradients."""
    g, n, x = _small(23)
    rng = np.random.default_rng(23)
    for shape_h in ((), (2, 3)):
        ins = [torch.tensor(rng.standard_normal((n,) + shape_h + (w,)))
               for w in (5, 5, 3)]
        ins += [torch.tensor(rng.standard_normal((n,) + shape_h)),
                torch.tensor(rng.standard_normal((n,) + shape_h + (3,)))]
        cot = torch.tensor(rng.standard_normal((n,) + shape_h + (3,)))
        results = []
        for kernels in (False, True):
            monkeypatch.setattr(TA, "_kernel_route", lambda t, k=kernels: k)
            ts = [a.clone().requires_grad_() for a in ins]
            out = TA.dot_attention(g, *ts[:3], SCALE, self_logits=ts[3],
                                   self_values=ts[4])
            lg = TA.dot_attention_logits(g, ts[0], ts[1])
            ((out * cot).sum() + (lg * lg).sum()).backward()
            results.append([out.detach(), lg.detach()]
                           + [t.grad for t in ts])
        assert results[1][0].shape == (n,) + shape_h + (3,)
        assert results[1][1].shape == (g.num_edges,) + shape_h
        for a, b in zip(*results):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F64_TOL)


def test_bipartite_dot_attention_kernels_match_plain(monkeypatch):
    """20 receivers (``num_segments``) of 30 nodes: the kernel route cuts
    the receiver CSR to q's rows and the sender CSR to k's and v's."""
    rng = np.random.default_rng(24)
    s, r = rng.integers(0, 30, 120), rng.integers(0, 20, 120)
    g = tgnn.graph(s, r, num_nodes=30, device="cpu")

    def x(*shape):
        return torch.tensor(rng.standard_normal(shape), requires_grad=True)

    ins = [x(20, 2, 3), x(30, 2, 3), x(30, 2, 4), x(20, 2), x(20, 2, 4)]
    cot = torch.tensor(rng.standard_normal((20, 2, 4)))
    results = []
    for kernels in (False, True):
        monkeypatch.setattr(TA, "_kernel_route", lambda t, k=kernels: k)
        for t in ins:
            t.grad = None
        out = TA.dot_attention(g, *ins[:3], SCALE, self_logits=ins[3],
                               self_values=ins[4], num_segments=20)
        (out * cot).sum().backward()
        results.append([out.detach()] + [t.grad for t in ins])
    for a, b in zip(*results):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F64_TOL)


@pytest.mark.parametrize("side", ["receiver", "sender"])
def test_dot_rows_past_the_cut_raise(side):
    """A receiver at or past q's rows, or a sender at or past k's and v's
    rows, would have the card read past the per-node state."""
    g = tgnn.graph([0, 1, 2, 3], [3, 0, 1, 2], num_nodes=4, device="cpu")
    full, cut = torch.zeros(4, 1, 2), torch.zeros(3, 1, 2)
    q, kv = (cut, full) if side == "receiver" else (full, cut)
    for call in (lambda: ES.dot_attention_nodes(g, q, kv, kv, SCALE),
                 lambda: SD.sddmm(g, q, kv)):
        with pytest.raises(ValueError, match=f"a {side} at or past"):
            call()


def test_dot_backward_computes_only_what_is_needed(monkeypatch):
    """``needs_input_grad``: with only k or v requiring a gradient the
    receiver-side sweep (K7) is skipped, and with only q the sender side
    (K8); SDDMM's backward runs only the K1 sweeps it needs."""
    g, n, x = _small(25)
    calls = []
    for name in ("dot_bwd_dq", "dot_bwd_rev"):
        fn = getattr(ES, name)
        monkeypatch.setattr(ES, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    for grad_of, want in ((1, ["dot_bwd_rev"]), (2, ["dot_bwd_rev"]),
                          (0, ["dot_bwd_dq"])):
        ins = [x(n, 2, 3).detach(), x(n, 2, 3).detach(), x(n, 2, 4).detach()]
        ins[grad_of].requires_grad_()
        calls.clear()
        ES.dot_attention_nodes(g, *ins, SCALE).sum().backward()
        assert calls == want
    spmm_calls = []
    spmm_csr = SD.spmm_csr
    monkeypatch.setattr(SD, "spmm_csr",
                        lambda *a: spmm_calls.append(a[2]) or spmm_csr(*a))
    a, b = x(n, 4), x(n, 4).detach()
    SD.sddmm(g, a, b).sum().backward()
    assert len(spmm_calls) == 1 and spmm_calls[0] is None   # receiver CSR
    assert a.grad is not None


def test_cpu_tensors_launch_nothing(route):
    g, n, x = _small(26)
    before = (dict(ES.launches), dict(SD.launches))
    out = TA.dot_attention(g, x(n, 2, 3), x(n, 2, 3), x(n, 2, 4), SCALE,
                           self_logits=x(n, 2), self_values=x(n, 2, 4))
    out.sum().backward()
    ES.dot_attention_nodes(g, x(n, 1, 3), x(n, 1, 3), x(n, 1, 3), SCALE,
                           0.2).sum().backward()
    TA.dot_attention_logits(g, x(n, 2, 3), x(n, 2, 3)).sum().backward()
    xx = x(n, 5)
    tops.apply_edges(tops.xi_dot_xj, g, xi=xx, xj=xx).sum().backward()
    assert (ES.launches, SD.launches) == before


def test_plain_dot_is_lrelu_slope_one():
    """The kernels run the plain dot as slope 1: the plain versions agree
    bit for bit, forward and backward."""
    g, n, x = _small(27)
    q, k, v, dy = (t.detach() for t in (x(n, 2, 3), x(n, 2, 3), x(n, 2, 4),
                                       x(n, 2, 4)))
    args = (g.indptr_r, g.col_r, q, k, v, SCALE)
    for a, b in zip(ES.dot_softmax_plain(*args, None),
                    ES.dot_softmax_plain(*args, 1.0)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    out, mx, den = ES.finalize_softmax(*ES.dot_softmax_plain(*args, None))
    bwd = (q, k, v, mx, den, (out * dy).sum(-1), dy, SCALE)
    for fn, ip, col in ((ES.dot_bwd_dq_plain, g.indptr_r, g.col_r),
                        (ES.dot_bwd_rev_plain, g.indptr_s, g.col_s)):
        a, b = fn(ip, col, *bwd, None), fn(ip, col, *bwd, 1.0)
        for u, w in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u.numpy(), w.numpy())
    assert ES._kernel_slope(None) == 1.0 and ES._kernel_slope(0.2) == 0.2
