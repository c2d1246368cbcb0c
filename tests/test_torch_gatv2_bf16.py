"""bfloat16 GATv2 (K9, K10, K11) against the JAX package on the CPU, and
``Precision`` over two GATv2 layers.

The JAX side runs as its own tests run it, under ``jax.jit``: graphs built
with ``build_spmm_aux=True`` (N <= 128 nodes, E <= 512 edges: one Pallas
block), so its GATv2 attention without dropout goes through the Pallas
kernels (``_flash_gatv2_kernel``, ``_gatv2_bwd_fwd_kernel``,
``_gatv2_bwd_rev_kernel``) in interpret mode, and with dropout through its
gathered logits and K12. Inputs are made with numpy in float32 and cast to
bfloat16 on both sides (the same bits). The port runs each case by its
plain route and by the card's autograd function on CPU tensors
(``kernels``: ``_kernel_route`` monkeypatched to True; the kernels take
their plain versions here).

Tolerances, with bfloat16's unit roundoff u = 2^-8 (a rounding to nearest
moves a value by at most u times its size; one ulp is 2u), against S, the
same sum taken over the absolute values of its terms (float64, from the
bfloat16 inputs), plus 1e-5 S + 1e-6 for the float32 sums' order. Both
sides widen q, k and a before any arithmetic, so ``raw = q[r] + k[s]``,
``act`` and the logit agree to float32 rounding; the softmax state (m, s,
mx, den) is float32 on both.

- ``out``: JAX's K9 rounds each weight ``p`` to bfloat16 before its dot
  (``edge_softmax.py:1293-1296``), the numerator ``y`` (``:1369``) and
  ``out``: 3 u S; the port's kernels route rounds ``num`` and ``out``
  (2 u S), its plain route ``out`` only: 5 u S between them.
- ``dq``, ``dk``, ``da`` and the self logit's gradient: each is a float32
  sum on both sides, rounded once each (2 u), of terms ``dlg = alpha
  (<k, dy> - s_n)`` in which only ``s_n = <out, dy>`` differs: it carries
  each side's forward error (5 u S_out together) and JAX's bfloat16
  products and sum (2 u): 7 u of ``sum_o S_out |dy|``. So each gradient
  is within 9 u of its S, where S takes ``alpha (sum_o |k dy| + sum_o
  S_out |dy|)`` for each term's ``|dlg|`` (times ``|a| lrelu'`` for
  ``dq`` and ``dk``, ``|act|`` for ``da``; ``dk`` adds ``alpha |dy|``).
  The cancellation in ``<k, dy> - s_n`` (GATv2's ``dq`` is poorly
  conditioned: JAX's own bfloat16 ``dq`` is 3.5 % off its float32 one by
  norm at N = 100) is why S, and not max |dq|, is the scale.
- The self value's gradient: one float32 product rounded on each side,
  2 u S.
- ``Precision(GNNChain(GATv2Conv, GATv2Conv))``: the two sides round the
  same values at the same points, except where a float32 sum is taken in
  another order (a dense product, an attention sum: one ulp, 2u, each) or
  JAX rounds more (the attention weights and the numerator, 2u). Per
  layer: the dense product (2 u), the self logit's einsum (2 u) and the
  attention (5 u), 9 u; the layers' gains about 1 (Glorot weights,
  attention), two layers 18 u of max |out|, and each parameter gradient
  18 u by norm. With attention dropout both sides gather the logits in
  bfloat16 (``lrelu(q[r] + k[s])`` and the einsum: 2 u more a layer) and
  sum on K12 (5 u): 22 u.
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
from graphneuralnetworks_tpu.models import conv as JC  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.models import conv as TC  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from torch_parity import graph_pair, pure_params  # noqa: E402

U = 2.0 ** -8                      # bfloat16's unit roundoff
N, E = 100, 400                    # one Pallas block: N <= 128, E <= 512
SLOPE = 0.2
KEEP = 2.5                         # a kept weight's dropout scale, p = 0.6
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


# ---- gatv2_attention: K9, K10, K11 ---------------------------------------

def _gatv2_scales(tg, q, k, a, sl, sv, dy):
    """S of ``out`` and of each gradient ``dq, dk, da, dsl, dsv`` (module
    docstring), in float64 from the bfloat16 values."""
    s, r, n = tg.senders.numpy(), tg.receivers.numpy(), tg.num_nodes
    raw = q[r] + k[s]                                          # [E, H, O]
    act = np.where(raw >= 0, raw, SLOPE * raw)
    dsig = np.where(raw >= 0, 1.0, SLOPE)
    lg = np.einsum("eho,oh->eh", act, a)
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
    sv_abs = np.abs(sv) if sv is not None else np.zeros(q.shape)
    s_out = a_self[..., None] * sv_abs
    np.add.at(s_out, r, alpha[..., None] * np.abs(k[s]))
    sn_abs = np.sum(s_out * np.abs(dy), -1)                     # [n, H]
    terms = alpha * (np.sum(np.abs(k[s] * dy[r]), -1) + sn_abs[r])
    draw = terms[..., None] * np.abs(a.T) * dsig                # [E, H, O]
    s_dq, s_dk = np.zeros(q.shape), np.zeros(k.shape)
    np.add.at(s_dq, r, draw)
    np.add.at(s_dk, s, draw + alpha[..., None] * np.abs(dy[r]))
    s_da = np.einsum("eh,eho->oh", terms, np.abs(act))
    s_dsl = a_self * (np.sum(sv_abs * np.abs(dy), -1) + sn_abs)
    s_dsv = a_self[..., None] * np.abs(dy)
    assert n == q.shape[0]
    return s_out, [s_dq, s_dk, s_da, s_dsl, s_dsv]


@functools.cache
def _jax_gatv2(heads, o, with_self):
    """Inputs (float32 numpy) and JAX's bfloat16 output and gradients of
    ``sum(out * cot)`` through the Pallas kernels, once per case."""
    jg, _ = _graphs(3 + heads + o)
    rng = np.random.default_rng(heads * 100 + o + with_self)
    shapes = [(jg.n_pad, heads, o), (jg.n_pad, heads, o), (o, heads),
              (jg.n_pad, heads) if with_self else None,
              (jg.n_pad, heads, o) if with_self else None]
    raw = [None if sh is None else rng.standard_normal(sh).astype(np.float32)
           for sh in shapes]
    raw[2] *= np.float32((2.0 / (o + heads)) ** 0.5)   # a at Glorot's scale
    cot = rng.standard_normal((N, heads, o)).astype(np.float32)
    present = [i for i, a in enumerate(raw) if a is not None]

    def jloss(*xs):
        args = [None] * 5
        for i, xx in zip(present, xs):
            args[i] = xx
        out = JA.gatv2_attention(jg, args[0], args[1], args[2], SLOPE,
                                 self_logits=args[3], self_values=args[4])
        return jnp.sum(out[:N].astype(jnp.float32) * cot), out[:N]

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(present))), has_aux=True))(
        *[_pair(raw[i])[0] for i in present])
    grads = [None] * 5
    for i, gr in zip(present, jgrads):
        grads[i] = gr
    return raw, cot, jout, grads


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("heads,o", [(1, 8), (2, 4), (4, 32), (1, 13)])
@pytest.mark.parametrize("with_self", [False, True])
def test_gatv2_attention_bf16_matches_pallas(monkeypatch, route, heads, o,
                                             with_self):
    """gatv2_attention on bfloat16 q, k, a (and the self-loop terms),
    forward and every gradient, against the Pallas K9, K10 and K11 within
    the module docstring's bounds over S; outputs and gradients in bfloat16.
    The widths cover the card's row vectors of 8 values (O = 8, 32), 4 (O =
    4) and 1 (O = 13)."""
    _route(monkeypatch, route)
    _, tg = _graphs(3 + heads + o)
    raw, cot, jout, jgrads = _jax_gatv2(heads, o, with_self)
    rows = [N, N, o, N, N]
    targs = [None if a is None else _pair(a)[1][:n].clone().requires_grad_()
             for a, n in zip(raw, rows)]
    tout = TA.gatv2_attention(tg, targs[0], targs[1], targs[2], SLOPE,
                              self_logits=targs[3], self_values=targs[4])
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16

    vals = [None if t is None else _np(t) for t in targs]
    dy = _np(torch.tensor(cot).to(torch.bfloat16))
    s_out, s_grads = _gatv2_scales(tg, *vals, dy)
    _within("out", tout, jout, s_out, 5)
    for name, k, t, jgrad, sc, n in zip(["dq", "dk", "da", "dsl", "dsv"],
                                        [9, 9, 9, 9, 2], targs, jgrads,
                                        s_grads, rows):
        if t is None:
            continue
        assert t.grad.dtype == torch.bfloat16, name
        _within(name, t.grad, jgrad[:n], sc, k)


@pytest.mark.parametrize("masked", [False, True])
def test_gatv2_plain_route_logits(monkeypatch, masked):
    """The CPU path computes GATv2's gathered logits in float32 for
    bfloat16 projections without dropout (as K9 and JAX's Pallas kernel
    keep ``raw``, ``act`` and the logit, ``edge_softmax.py:1276-1280``),
    and in bfloat16 with dropout masks (as JAX gathers them,
    ``ops/attention.py:59-62``); the output is bfloat16 either way."""
    seen = []
    real = TA.attention_aggregate

    def spy(g, logits, values, **kw):
        seen.append((logits.dtype, values.dtype))
        return real(g, logits, values, **kw)
    monkeypatch.setattr(TA, "attention_aggregate", spy)
    _, tg = _graphs(7)
    rng = np.random.default_rng(7)

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).bfloat16()
    masks = None
    if masked:
        masks = (torch.full((tg.num_edges, 2), KEEP).bfloat16(),
                 torch.full((N, 2), KEEP).bfloat16())
    out = TA.gatv2_attention(tg, bf(N, 2, 4), bf(N, 2, 4), bf(4, 2), SLOPE,
                             self_logits=bf(N, 2), self_values=bf(N, 2, 4),
                             dropout_masks=masks)
    want = torch.bfloat16 if masked else torch.float32
    assert seen[0] == (want, torch.bfloat16)   # then its float32 work
    assert out.dtype == torch.bfloat16


# ---- Precision -----------------------------------------------------------

def _hold(name, ty, jy, k):
    got, want = _np(ty), _np(jy)
    err = np.max(np.abs(got - want))
    assert err <= k * U * np.max(np.abs(want)), (
        name, err / (k * U * np.max(np.abs(want))))


def _hold_grads(tm, jgrads, k):
    """Every float32 parameter gradient of ``tm`` within ``k u`` by norm of
    JAX's (carried over by load_jax_params)."""
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(jgrads)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 ref.named_parameters()):
        a, b = p.grad, q.detach()
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        a, b = a.double(), b.double()
        assert float((a - b).norm() / b.norm()) <= k * U, name


def _jax_step(jm, loss_of, x):
    """JAX's output of ``loss_of(model, x)`` and the parameters' gradients
    of the sum of its squares."""
    gd, st, rest = nnx.split(jm, nnx.Param, ...)

    def loss(st, xx):
        out = loss_of(nnx.merge(gd, st, rest), xx)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jy), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(st, x)
    return jy, grads


def _models(dropout):
    jm = JM.Precision(JM.GNNChain(
        JM.GATv2Conv(8, 4, jax.nn.relu, heads=2, dropout=dropout,
                     rngs=nnx.Rngs(6)),
        JM.GATv2Conv(8, 4, dropout=dropout, rngs=nnx.Rngs(7))))
    tm = load_jax_params(TM.Precision(TM.GNNChain(
        TM.GATv2Conv(8, 4, torch.relu, heads=2, dropout=dropout,
                     device="cpu"),
        TM.GATv2Conv(8, 4, dropout=dropout, device="cpu"))), pure_params(jm))
    return jm, tm


@pytest.mark.parametrize("route", ROUTES)
def test_precision_gatv2_matches_jax(monkeypatch, route):
    """``Precision(GNNChain(GATv2Conv(heads=2), GATv2Conv))`` without
    dropout (K9, K10 and K11 in bfloat16 on the card; JAX's Pallas kernels
    here), carried over by load_jax_params: the output within 18 u of max
    |out|, every parameter gradient within 18 u by norm."""
    _route(monkeypatch, route)
    jg, tg = _graphs(64)
    x = np.random.default_rng(64).standard_normal(
        (jg.n_pad, 8)).astype(np.float32)
    jm, tm = _models(0.0)
    jy, jgrads = _jax_step(jm, lambda m, xx: m(jg, xx)[:N], jnp.asarray(x))
    ty = tm(tg, torch.tensor(x[:N]))
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 18)
    _hold_grads(tm, jgrads, 18)


def test_precision_gatv2_dropout_matches_jax(monkeypatch):
    """The same model with attention dropout 0.6 in training mode, both
    sides handed one set of masks: the logits gathered in bfloat16 on both
    sides and summed on K12 (JAX's Pallas K12 here): the output within 22 u
    of max |out|, the gradients within 22 u by norm."""
    jg, tg = _graphs(65)
    rng = np.random.default_rng(65)
    x = rng.standard_normal((jg.n_pad, 8)).astype(np.float32)

    def draw(rows, heads):
        return (rng.random((rows, heads)) < 0.4).astype(np.float32) * KEEP
    masks = [(draw(jg.e_pad, h), draw(jg.n_pad, h)) for h in (2, 1)]
    jcalls, tcalls = iter(masks * 2), iter(masks * 2)

    def jmasks(module, g, n_dst, h, deterministic, with_self):
        me, ms = next(jcalls)
        return jnp.asarray(me), jnp.asarray(ms[:n_dst])

    def tmasks(p, gen, n_edges, n_dst, heads, with_self, device, dtype):
        me, ms = next(tcalls)
        return (torch.tensor(me[:n_edges]).to(dtype),
                torch.tensor(ms[:n_dst]).to(dtype))
    monkeypatch.setattr(JC, "_attn_dropout_masks", jmasks)
    monkeypatch.setattr(TC, "_attn_dropout_masks", tmasks)
    jm, tm = _models(0.6)
    jy, jgrads = _jax_step(
        jm, lambda m, xx: m(jg, xx, deterministic=False)[:N], jnp.asarray(x))
    ty = tm(tg, torch.tensor(x[:N]), deterministic=False)
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 22)
    _hold_grads(tm, jgrads, 22)
