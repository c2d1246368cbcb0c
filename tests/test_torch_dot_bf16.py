"""bfloat16 dot attention (K6, K7, K8) against the JAX package on the CPU,
and ``Precision`` over two TransformerConv and two AGNNConv layers.

The JAX side runs as its own tests run it, under ``jax.jit``: graphs built
with ``build_spmm_aux=True`` (N <= 128 nodes, E <= 512 edges: one Pallas
block), so its ``dot_attention`` goes through the Pallas kernels
(``_flash_dot_kernel``, ``_dot_bwd_dq_kernel``, ``_dot_bwd_dkv_kernel``)
in interpret mode. Inputs are made with numpy in float32 and cast to
bfloat16 on both sides (the same bits). The port runs each case by its
plain route and by the card's autograd function on CPU tensors
(``kernels``: ``_kernel_route`` monkeypatched to True; the kernels take
their plain versions here).

Tolerances, with bfloat16's unit roundoff u = 2^-8 (a rounding to nearest
moves a value by at most u times its size; one ulp is 2u), against S, the
same sum taken over the absolute values of its terms (float64, from the
bfloat16 inputs), plus 1e-5 S + 1e-6 for the float32 sums' order. Both
sides widen q and k before the dot, so the raw logit ``scale <q, k>``
agrees to float32 rounding; the softmax state (m, s, mx, den) is float32
on both.

- ``out``: JAX's K6 rounds each weight ``p`` to bfloat16 before its dot
  with ``v``, the numerator ``y`` (one edge block: one rescale of a zero
  ``y``) and ``out`` (``edge_softmax.py:336-339``): 3 u S; the port's
  kernels route rounds ``num`` and ``out`` (2 u S), its plain route
  ``out`` only: 5 u S between them.
- ``dq``, ``dk`` and the self logit's gradient: each is a float32 sum on
  both sides, rounded once each (2 u), of terms ``dlg = alpha (<v, dy> -
  s_n) dsig`` in which only ``s_n = <out, dy>`` differs: it carries each
  side's forward error (5 u S_out together) and JAX's bfloat16 products
  and sum (``edge_softmax.py:672``, 2 u): 7 u of ``sum_d S_out |dy|``. So
  each gradient is within 9 u of its S, where S takes ``alpha (sum_d |v
  dy| + sum_d S_out |dy|) |dsig|`` for each term's ``|dlg|``, times ``|k|``
  for ``dq`` and ``|q|`` for ``dk``. ``dq`` is poorly conditioned (a
  receiver's ``dlg_e`` sum to about 0, the softmax's Jacobian: JAX's own
  bfloat16 ``dq`` is over 1 % off float64 at N = 100), which is why S,
  and not max |dq|, is the scale.
- ``dv`` and the self value's gradient: one float32 sum of ``alpha dy``
  on each side, rounded once: 2 u S.
- ``Precision`` over two layers: the two sides round the same values at
  the same points, except where a float32 sum is taken in another order (a
  dense product, an attention sum: one ulp, 2 u, each), inputs already
  apart are rounded (2 u), or JAX rounds more (the attention weights and
  the numerator, 2 u). TransformerConv (root weight, no gating): the
  projection products (2 u; W3, W4 and W2 side by side on a path), the
  logit ``<q, k> / sqrt(O)`` in float32 from projections 2 u apart (its
  error, about 2 u of ``sum |q k| / sqrt(O)`` (about 1, Glorot weights),
  moves alpha by as much: 2 u), the attention (5 u), the root product
  (2 u) and the sum with it (2 u): 13 u a layer, 26 u for two, of max
  |out|, and each parameter gradient 26 u by norm. AGNNConv: the norm
  ``sqrt(sum x^2)`` (its sum 2 u, the square root u), ``x / norm`` (2 u
  of inputs already apart), ``beta x_n`` (2 u), the logits (within
  ``[-beta, beta]``: 2 u of beta) and the attention (5 u), 13 u a layer,
  26 u for two.
"""

import copy
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from torch_parity import graph_pair, pure_params  # noqa: E402

U = 2.0 ** -8                      # bfloat16's unit roundoff
N, E = 100, 400                    # one Pallas block: N <= 128, E <= 512
ROUTES = ["plain", "kernels"]


def _np(t):
    """A bfloat16 (or float) array of either package as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _pair(a):
    """float32 numpy -> (JAX bfloat16, the port's bfloat16), the same
    bits."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


@functools.cache
def _graphs(seed):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    jg, tg = graph_pair(s, r, N, aux=True, dtype=np.float32)
    assert jg.n_pad <= 128 and jg.e_pad <= 512
    return jg, tg


def _route(monkeypatch, route):
    if route == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)


def _within(name, got, want, scale, k):
    got, want = _np(got), _np(want)
    tol = k * U * scale + 1e-5 * scale + 1e-6
    err = np.abs(got - want)
    assert np.all(err <= tol), (name, float(np.max(err / tol)))


# ---- dot_attention: K6, K7, K8 -------------------------------------------

def _dot_scales(tg, q, k, v, sl, sv, dy, scale):
    """S of ``out`` and of each gradient ``dq, dk, dv, dsl, dsv`` (module
    docstring), in float64 from the bfloat16 values."""
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    lg = scale * np.einsum("eho,eho->eh", q[r], k[s])
    mx = np.full(q.shape[:2], -np.inf)
    np.maximum.at(mx, r, lg)
    if sl is not None:
        mx = np.maximum(mx, sl)
    mx = np.where(np.isneginf(mx), 0.0, mx)
    ex = np.exp(lg - mx[r])
    den = np.zeros(mx.shape)
    np.add.at(den, r, ex)
    ex_self = np.exp(sl - mx) if sl is not None else np.zeros(mx.shape)
    den = np.maximum(den + ex_self, np.finfo(np.float32).tiny)
    alpha, a_self = ex / den[r], ex_self / den
    sv_abs = np.abs(sv) if sv is not None else np.zeros(v.shape)
    s_out = a_self[..., None] * sv_abs
    np.add.at(s_out, r, alpha[..., None] * np.abs(v[s]))
    sn_abs = np.sum(s_out * np.abs(dy), -1)                     # [n, H]
    terms = (alpha * (np.sum(np.abs(v[s] * dy[r]), -1) + sn_abs[r])
             * abs(scale))
    s_dq, s_dk, s_dv = (np.zeros(x.shape) for x in (q, k, v))
    np.add.at(s_dq, r, terms[..., None] * np.abs(k[s]))
    np.add.at(s_dk, s, terms[..., None] * np.abs(q[r]))
    np.add.at(s_dv, s, alpha[..., None] * np.abs(dy[r]))
    s_dsl = a_self * (np.sum(sv_abs * np.abs(dy), -1) + sn_abs)
    s_dsv = a_self[..., None] * np.abs(dy)
    return s_out, [s_dq, s_dk, s_dv, s_dsl, s_dsv]


@functools.cache
def _jax_dot(heads, o, with_self, scale):
    """Inputs (float32 numpy) and JAX's bfloat16 output and gradients of
    ``sum(out * cot)`` through the Pallas kernels, once per case."""
    jg, _ = _graphs(5 + heads + o)
    rng = np.random.default_rng(heads * 100 + o + with_self)
    shapes = [(jg.n_pad, heads, o)] * 3 + [
        (jg.n_pad, heads) if with_self else None,
        (jg.n_pad, heads, o) if with_self else None]
    raw = [None if sh is None else rng.standard_normal(sh).astype(np.float32)
           for sh in shapes]
    cot = rng.standard_normal((N, heads, o)).astype(np.float32)
    present = [i for i, a in enumerate(raw) if a is not None]

    def jloss(*xs):
        args = [None] * 5
        for i, xx in zip(present, xs):
            args[i] = xx
        out = JA.dot_attention(jg, args[0], args[1], args[2], scale,
                               self_logits=args[3], self_values=args[4])
        return jnp.sum(out[:N].astype(jnp.float32) * cot), out[:N]

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(present))), has_aux=True))(
        *[_pair(raw[i])[0] for i in present])
    grads = [None] * 5
    for i, gr in zip(present, jgrads):
        grads[i] = gr
    return raw, cot, jout, grads


DOT_CASES = [(1, 8, 1.0), (2, 4, 1.0), (4, 32, 1.0), (1, 13, 1.0),
             (4, 32, 32 ** -0.5)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("heads,o,scale", DOT_CASES)
@pytest.mark.parametrize("with_self", [False, True])
def test_dot_attention_bf16_matches_pallas(monkeypatch, route, heads, o,
                                           scale, with_self):
    """dot_attention on bfloat16 q, k, v (and the self-loop terms), forward
    and every gradient, against the Pallas K6, K7 and K8 within the module
    docstring's bounds over S; outputs and gradients in bfloat16. The
    widths cover the card's row vectors of 8 values (O = 8, 32), 4 (O = 4)
    and 1 (O = 13); (4, 32) also at TransformerConv's scale 1/sqrt(32)."""
    _route(monkeypatch, route)
    _, tg = _graphs(5 + heads + o)
    raw, cot, jout, jgrads = _jax_dot(heads, o, with_self, scale)
    targs = [None if a is None else _pair(a)[1][:N].clone().requires_grad_()
             for a in raw]
    tout = TA.dot_attention(tg, *targs[:3], scale, self_logits=targs[3],
                            self_values=targs[4])
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16

    vals = [None if t is None else _np(t) for t in targs]
    dy = _np(torch.tensor(cot).to(torch.bfloat16))
    s_out, s_grads = _dot_scales(tg, *vals, dy, scale)
    _within("out", tout, jout, s_out, 5)
    for name, k, t, jgrad, sc in zip(["dq", "dk", "dv", "dsl", "dsv"],
                                     [9, 9, 2, 9, 2], targs, jgrads,
                                     s_grads):
        if t is None:
            continue
        assert t.grad.dtype == torch.bfloat16, name
        _within(name, t.grad, jgrad[:N], sc, k)


def _bf(rng, *shape):
    return torch.tensor(rng.standard_normal(shape),
                        dtype=torch.float32).bfloat16()


def test_dot_plain_route_logits(monkeypatch):
    """The CPU path hands :func:`attention_aggregate` the logits ``scale *
    <q[r], k[s]>`` in float32 for bfloat16 projections, unrounded (as K6
    and JAX's Pallas kernel keep them, ``edge_softmax.py:320-322``); the
    output is bfloat16."""
    seen = []
    real = TA.attention_aggregate

    def spy(g, logits, values, **kw):
        seen.append(logits)
        return real(g, logits, values, **kw)
    monkeypatch.setattr(TA, "attention_aggregate", spy)
    _, tg = _graphs(7)
    rng = np.random.default_rng(7)
    q, k, v = _bf(rng, N, 2, 8), _bf(rng, N, 2, 8), _bf(rng, N, 2, 8)
    out = TA.dot_attention(tg, q, k, v, 1.0, self_logits=_bf(rng, N, 2),
                           self_values=_bf(rng, N, 2, 8))
    want = (q.float()[tg.receivers] * k.float()[tg.senders]).sum(-1)
    assert seen[0].dtype == torch.float32
    assert torch.equal(seen[0], want)
    assert out.dtype == torch.bfloat16


def _dot_step(monkeypatch, names):
    """One bfloat16 forward and backward of ``dot_attention_nodes`` with a
    self-loop, each of ``names`` (functions of ``edge_softmax``) spied on:
    the calls' arguments, and the inputs."""
    calls = []
    for name in names:
        def spy(*args, real=getattr(ES, name), name=name):
            calls.append((name, args))
            return real(*args)
        monkeypatch.setattr(ES, name, spy)
    _, tg = _graphs(9)
    rng = np.random.default_rng(9)
    ins = [_bf(rng, *sh).requires_grad_() for sh in
           ((N, 2, 4), (N, 2, 4), (N, 2, 6), (N, 2), (N, 2, 6))]
    out = ES.dot_attention_nodes(tg, *ins[:3], 0.5, self_logits=ins[3],
                                 self_values=ins[4])
    out.float().sum().backward()
    return calls, ins


def test_dot_forward_keeps_raw_logits_in_float32(monkeypatch):
    """DotAttentionFunction hands K6 an ``[E, H]`` float32 buffer for the
    raw logits of bfloat16 rows, and K7 reads them from it (JAX's K7 works
    from float32 logits, ``edge_softmax.py:569-596``)."""
    calls, _ = _dot_step(monkeypatch, ("dot_softmax", "dot_bwd_dq"))
    (k6, a6), (k7, a7) = calls
    assert (k6, k7) == ("dot_softmax", "dot_bwd_dq")
    assert a6[7].dtype == torch.float32 and a6[7].shape == (E, 2)
    assert a7[11].data_ptr() == a6[7].data_ptr()


def test_dot_backward_takes_s_n_in_float32(monkeypatch):
    """DotAttentionFunction's backward hands K7 and K8 ``s_n`` in float32
    for bfloat16 rows, as GAT's and GATv2's do, and returns every gradient
    in its primal's type."""
    calls, ins = _dot_step(monkeypatch, ("dot_bwd_dq", "dot_bwd_rev"))
    assert [(name, a[7].dtype) for name, a in calls] == [
        ("dot_bwd_dq", torch.float32), ("dot_bwd_rev", torch.float32)]
    assert all(t.grad.dtype == torch.bfloat16 for t in ins)


# ---- Precision -----------------------------------------------------------

def _hold(name, ty, jy, k):
    got, want = _np(ty), _np(jy)
    err = np.max(np.abs(got - want))
    assert err <= k * U * np.max(np.abs(want)), (
        name, err / (k * U * np.max(np.abs(want))))


def _hold_grads(tm, jgrads, k):
    """Every float32 parameter gradient of ``tm`` within ``k u`` by norm of
    JAX's (carried over by load_jax_params). The key bias of a
    TransformerConv (``W4.bias``) shifts every logit of a receiver's
    softmax by the same ``<q[r], b>``, which the softmax does not see: its
    gradient is 0 in exact arithmetic, and each side's is the rounding of
    terms at the scale of the other gradients, so it is held within ``k
    u`` of the largest gradient's norm."""
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(jgrads)))
    largest = max(float(q.detach().double().norm())
                  for q in ref.parameters())
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 ref.named_parameters()):
        a, b = p.grad, q.detach()
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        a, b = a.double(), b.double()
        scale = largest if name.endswith("W4.bias") else float(b.norm())
        assert float((a - b).norm()) <= k * U * scale, (
            name, float((a - b).norm()) / (k * U * scale))


def _models(kind):
    if kind == "transformer":
        jm = JM.Precision(JM.GNNChain(
            JM.TransformerConv(8, 4, heads=2, rngs=nnx.Rngs(6)),
            JM.TransformerConv(8, 4, rngs=nnx.Rngs(7))))
        tm = TM.Precision(TM.GNNChain(
            TM.TransformerConv(8, 4, heads=2, device="cpu"),
            TM.TransformerConv(8, 4, device="cpu")))
    else:
        jm = JM.Precision(JM.GNNChain(JM.AGNNConv(rngs=nnx.Rngs(6)),
                                      JM.AGNNConv(rngs=nnx.Rngs(7))))
        tm = TM.Precision(TM.GNNChain(TM.AGNNConv(device="cpu"),
                                      TM.AGNNConv(device="cpu")))
    return jm, load_jax_params(tm, pure_params(jm))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["transformer", "agnn"])
def test_precision_dot_attention_matches_jax(monkeypatch, route, kind):
    """``Precision(GNNChain(TransformerConv(heads=2), TransformerConv))``
    and ``Precision(GNNChain(AGNNConv(), AGNNConv()))`` (K6, K7 and K8 in
    bfloat16 on the card; JAX's Pallas kernels here), carried over by
    load_jax_params: the output within 26 u of max |out|, every parameter
    gradient within 26 u by norm (module docstring; the key bias's, whose
    exact value is 0, of the largest gradient's norm)."""
    _route(monkeypatch, route)
    jg, tg = _graphs(66)
    x = np.random.default_rng(66).standard_normal(
        (jg.n_pad, 8)).astype(np.float32)
    jm, tm = _models(kind)
    gd, st, rest = nnx.split(jm, nnx.Param, ...)

    def loss(st, xx):
        out = nnx.merge(gd, st, rest)(jg, xx)[:N]
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jy), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        st, jnp.asarray(x))
    ty = tm(tg, torch.tensor(x[:N]))
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 26)
    _hold_grads(tm, jgrads, 26)
