"""Mixed precision: ``models.Precision`` and the bfloat16 kernels' functions
(K1, and GAT's K3, K4, K5) against the JAX package, on the CPU.

The JAX side runs as its own tests run it: ``build_spmm_aux=True``, so its
SpMM and GAT attention go through the Pallas kernels in interpret mode. The
graphs have N <= 128 nodes and E <= 512 edges, so that JAX's kernels sum
every output in one float32 block (``BN=128``, ``BE=512``,
``ops/pallas/spmm.py:54-55``) before their single rounding to bfloat16.
Inputs are made with numpy in float32 and cast to bfloat16 on both sides;
both casts round to nearest even, so both sides see the same bits.

Tolerances, with bfloat16's unit roundoff u = 2^-8 (a rounding to
nearest moves a value by at most u times its size; one ulp is 2u):

- ``spmm``: both sides take the exact float32 products of bfloat16 values
  and round one float32 sum each; the sums differ only in order (the JAX
  package's own kernel tolerance, 1e-5), so a rounding may land one ulp
  apart: one bfloat16 ulp of the result plus the float32 tolerance.
- ``gat_attention``: measured against S, the same sum taken over the
  absolute values of its terms (f64, from the bfloat16 inputs): an error
  of rounding a sum, or a term, is at most u * S. Forward: the port rounds
  ``num`` and then ``out`` (2 u S); JAX's kernel also rounds each
  attention weight to bfloat16 before its dot (``p.astype(v.dtype)``,
  ``ops/pallas/edge_softmax.py:857``), 3 u S: 5 u S between them. ``dv``
  and the self value's gradient are one float32 sum each, rounded once on
  each side: 2 u S. ``dpi``, ``dpj`` and the self logit's gradient take
  ``s_n = <out, dy>`` per receiver, which carries each side's forward
  error (5 u S_out together), JAX's bfloat16 product and sum (2 u) and
  the final rounding on each side (2 u): 9 u S, with ``S_out |dy|`` in
  place of ``|out dy|`` in S. Each bound adds 1e-5 S + 1e-6 for the
  float32 sums.
- ``Precision`` over ``GNNChain(GCNConv, GATConv)`` (JAX's own test,
  ``tests/test_basics_plumbing.py:170-200``): the two sides round the
  same values at the same points, except where their float32 sums differ
  in order (the dense products, the SpMM, the attention sums) or JAX
  rounds more (the attention weights; ``pj`` regathered from the value
  rows in float32, ``pj_weight``). A layer has at most two such roundings
  on a path to its output (a product, an aggregation: one ulp, 2u, each)
  and one on the softmax weights (u), 5 u of the output's scale; the
  layers' maps have gains about 1 (normalised propagation, Glorot
  weights), so two layers give 10 u = 0.039 of max |out|, below JAX's own
  0.05 for bfloat16 against float32. The gradients by norm, the same
  count: 10 u.
- Degree counts (star graphs, hub in-degree 255, 256, 257 and 1,099):
  ``degree`` exactly; ``propagate``'s mean bit for bit on integer rows
  (every float32 sum exact); ``Precision(GCNConv)`` within 10 u of
  ``|m| @ |W|`` per output (each test's docstring).
- BatchNorm under ``Precision``: its running statistics stay at their
  initial values on both sides (exact).
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
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402
from torch_parity import graph_pair, pad_rows, pure_params  # noqa: E402

U = 2.0 ** -8                      # bfloat16's unit roundoff
F32_TOL = dict(rtol=1e-5, atol=1e-5)
SLOPE = 0.2
N, E = 100, 400                    # one Pallas block: N <= 128, E <= 512


def _bf16_ulp(a):
    """One bfloat16 ulp at each |a| (the smallest normal's at 0)."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _np(t):
    """A bfloat16 (or float) array of either package as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _graphs(seed=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    w = rng.random(E) + 0.5
    jg, tg = graph_pair(s, r, N, w, aux=True, dtype=np.float32)
    assert jg.n_pad <= 128 and jg.e_pad <= 512
    return jg, tg, rng


def _pair(a):
    """float32 numpy -> (JAX bfloat16, the port's bfloat16): one rounding
    to nearest even each, the same bits."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


# ---- K1: spmm -----------------------------------------------------------

@pytest.mark.parametrize("msg", ["copy_xj", "w_mul_xj", "e_mul_xj"])
@pytest.mark.parametrize("width", [8, 13, 128])
def test_spmm_bf16_matches_pallas(msg, width):
    """propagate(sum) in bfloat16: y and dx (and the learned weights' dw
    for e_mul_xj: K2's bfloat16 variant on the card, two strips at 128)
    against the Pallas kernels, within one ulp plus the float32
    tolerance."""
    jg, tg, rng = _graphs(1)
    ne = tg.num_edges
    x = rng.standard_normal((N, width)).astype(np.float32)
    e = (rng.random(ne) + 0.5).astype(np.float32)
    cot = rng.standard_normal((N, width)).astype(np.float32)
    (jx, tx), (je, te) = _pair(pad_rows(x, jg.n_pad)), _pair(
        pad_rows(e, jg.e_pad))
    tx, te = tx[:N].requires_grad_(), te[:ne].requires_grad_()
    jf, tf = getattr(jops, msg), getattr(tops, msg)
    use_e = msg == "e_mul_xj"

    def jloss(xp, ep):
        y = jops.propagate(jf, jg, "sum", xj=xp, e=ep if use_e else None)
        return jnp.sum(y[:N].astype(jnp.float32) * cot), y[:N]

    (_, jy), (jdx, jde) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jx, je)
    ty = tops.propagate(tf, tg, "sum", xj=tx, e=te if use_e else None)
    (ty.float() * torch.tensor(cot)).sum().backward()
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    assert tx.grad.dtype == torch.bfloat16
    pairs = [(ty, jy), (tx.grad, jdx[:N])]
    if use_e:
        assert te.grad.dtype == torch.bfloat16
        pairs.append((te.grad, jde[:ne]))
    for got, want in pairs:
        got, want = _np(got), _np(want)
        tol = _bf16_ulp(want) + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(
            want)
        assert np.all(np.abs(got - want) <= tol), np.max(
            np.abs(got - want) / tol)


# ---- K3, K4, K5: gat_attention ------------------------------------------

def _gat_scales(tg, pi, pj, v, sl, sv, dy):
    """S for each output of gat_attention and each gradient (see the module
    docstring), in float64 from the bfloat16 values."""
    s, r, n = tg.senders.numpy(), tg.receivers.numpy(), tg.num_nodes
    raw = pi[r] + pj[s]
    lg = np.where(raw >= 0, raw, SLOPE * raw)                   # [E, H]
    mx = np.full(pi.shape, -np.inf)
    np.maximum.at(mx, r, lg)
    if sl is not None:
        mx = np.maximum(mx, sl)
    mx = np.where(np.isneginf(mx), 0.0, mx)
    ex = np.exp(lg - mx[r])
    den = np.zeros(pi.shape)
    np.add.at(den, r, ex)
    ex_self = np.exp(sl - mx) if sl is not None else np.zeros(pi.shape)
    den = np.maximum(den + ex_self, np.finfo(np.float32).tiny)
    alpha, a_self = ex / den[r], ex_self / den
    sv_abs = np.abs(sv) if sv is not None else np.zeros(v.shape)
    s_out = a_self[..., None] * sv_abs
    np.add.at(s_out, r, alpha[..., None] * np.abs(v[s]))
    sn_abs = np.sum(s_out * np.abs(dy), -1)                    # [n, H]
    terms = alpha * (np.sum(np.abs(v[s] * dy[r]), -1) + sn_abs[r])
    s_dpi, s_dpj = np.zeros(pi.shape), np.zeros(pj.shape)
    np.add.at(s_dpi, r, terms)
    np.add.at(s_dpj, s, terms)
    s_dv = np.zeros(v.shape)
    np.add.at(s_dv, s, alpha[..., None] * np.abs(dy[r]))
    s_dsl = a_self * (np.sum(sv_abs * np.abs(dy), -1) + sn_abs)
    s_dsv = a_self[..., None] * np.abs(dy)
    assert n == pi.shape[0]
    return s_out, [s_dpi, s_dpj, s_dv, s_dsl, s_dsv]


def _within(name, got, want, scale, k):
    got, want = _np(got), _np(want)
    tol = k * U * scale + 1e-5 * scale + 1e-6
    err = np.abs(got - want)
    assert np.all(err <= tol), (name, float(np.max(err / tol)))


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("heads,d,with_self", [(1, 8, False), (2, 8, True),
                                                (4, 32, True), (1, 13, True)])
def test_gat_attention_bf16_matches_pallas(monkeypatch, route, heads, d,
                                           with_self):
    """gat_attention on bfloat16 inputs, forward and every gradient,
    against the Pallas kernels (K3, K4, K5), within the bounds derived in
    the module docstring; outputs and gradients in their inputs' type.
    ``kernels`` sends the CPU tensors through the card's autograd function
    (the kernels' plain versions), ``plain`` takes the CPU path."""
    if route == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    jg, tg, rng = _graphs(2 + heads + d)
    shapes = [(jg.n_pad, heads), (jg.n_pad, heads), (jg.n_pad, heads, d),
              (jg.n_pad, heads) if with_self else None,
              (jg.n_pad, heads, d) if with_self else None]
    raw = [None if sh is None else rng.standard_normal(sh) for sh in shapes]
    pairs = [None if a is None else _pair(a) for a in raw]
    cot = rng.standard_normal((N, heads, d)).astype(np.float32)
    present = [i for i, p in enumerate(pairs) if p is not None]

    def jloss(*xs):
        args = [None] * 5
        for i, xx in zip(present, xs):
            args[i] = xx
        out = JA.gat_attention(jg, args[0], args[1], args[2], SLOPE,
                               self_logits=args[3], self_values=args[4])
        return jnp.sum(out[:N].astype(jnp.float32) * cot), out[:N]

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(present))), has_aux=True)(
        *[pairs[i][0] for i in present])
    targs = [None if p is None else p[1][:N].clone().requires_grad_()
             for p in pairs]
    tout = TA.gat_attention(tg, targs[0], targs[1], targs[2], SLOPE,
                            self_logits=targs[3], self_values=targs[4])
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16

    vals = [None if p is None else _np(p[1][:N]) for p in pairs]
    dy = _np(torch.tensor(cot).to(torch.bfloat16))
    s_out, s_grads = _gat_scales(tg, *vals, dy)
    _within("out", tout, jout, s_out, 5)
    names = ["dpi", "dpj", "dv", "dsl", "dsv"]
    ks = [9, 9, 2, 9, 2]
    for i, jgrad in zip(present, jgrads):
        assert targs[i].grad.dtype == torch.bfloat16, names[i]
        _within(names[i], targs[i].grad, jgrad[:N], s_grads[i], ks[i])


# ---- the plain versions: bfloat16 is float32 rounded once ----------------

def _rand_csr_args(rng, heads, d):
    """A receiver CSR, its sender CSR, and GAT's inputs in float32 with
    bfloat16 values."""
    g = tgnn.rand_graph(40, 160, seed=int(rng.integers(1000)), device="cpu")

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(torch.bfloat16)
    return g, bf


PLAIN_CASES = ["spmm", "spmm_weighted", "spmm_sddmm", "gat_softmax",
               "gat_bwd_dpi", "gat_bwd_rev", "gatv2_softmax", "gatv2_bwd_dq",
               "gatv2_bwd_rev", "dot_softmax", "dot_softmax_slope",
               "dot_bwd_dq", "dot_bwd_rev"]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_versions_bf16_are_float32_rounded_once(case):
    """Each plain version on bfloat16 inputs gives exactly its float32
    result on the same (widened) values, rounded once to bfloat16; float32
    outputs (the softmax state) exactly the float32 ones."""
    rng = np.random.default_rng(PLAIN_CASES.index(case))
    g, bf = _rand_csr_args(rng, 2, 6)
    n = g.num_nodes
    ir, cr, is_, cs, es = g.indptr_r, g.col_r, g.indptr_s, g.col_s, g.eid_s
    if case.startswith("spmm"):
        x, w = bf(n, 6), bf(g.num_edges)
        args = {"spmm": (S.spmm_plain, (ir, cr, None, None, x)),
                "spmm_weighted": (S.spmm_plain, (is_, cs, es, w, x)),
                "spmm_sddmm": (S.spmm_sddmm_plain,
                               (is_, cs, es, w, bf(n, 6), x))}[case]
    elif case.startswith("dot"):
        h, o, d = 2, 6, 5
        slope = SLOPE if case == "dot_softmax_slope" else None
        q, k, v, dy = bf(n, h, o), bf(n, h, o), bf(n, h, d), bf(n, h, d)
        num, m, s = ES.dot_softmax_plain(ir, cr, q, k, v, 0.4, slope)
        out, mx, den = ES.finalize_softmax(num, m, s)
        s_n = (out.float() * dy.float()).sum(-1)
        bwd = (q, k, v, mx, den, s_n, dy, 0.4, slope)
        args = {"dot_softmax": (ES.dot_softmax_plain,
                                (ir, cr, q, k, v, 0.4, slope)),
                "dot_bwd_dq": (ES.dot_bwd_dq_plain, (ir, cr) + bwd),
                "dot_bwd_rev": (ES.dot_bwd_rev_plain, (is_, cs) + bwd)
                }[case.replace("_slope", "")]
    elif case.startswith("gatv2"):
        h, o = 2, 6
        q, k, dy, a = bf(n, h, o), bf(n, h, o), bf(n, h, o), bf(o, h)
        num, m, s = ES.gatv2_softmax_plain(ir, cr, q, k, a, SLOPE)
        out, mx, den = ES.finalize_softmax(num, m, s)
        s_n = (out.float() * dy.float()).sum(-1)
        bwd = (q, k, a, mx, den, s_n, dy, SLOPE)
        args = {"gatv2_softmax": (ES.gatv2_softmax_plain,
                                  (ir, cr, q, k, a, SLOPE)),
                "gatv2_bwd_dq": (ES.gatv2_bwd_dq_plain, (ir, cr) + bwd),
                "gatv2_bwd_rev": (ES.gatv2_bwd_rev_plain,
                                  (is_, cs) + bwd)}[case]
    else:
        h, d = 2, 6
        pi, pj, v, dy = bf(n, h), bf(n, h), bf(n, h, d), bf(n, h, d)
        num, m, s = ES.gat_softmax_plain(ir, cr, pi, pj, v, SLOPE)
        out, mx, den = ES.finalize_softmax(num, m, s)
        s_n = (out.float() * dy.float()).sum(-1)
        csr = ir, cr
        if case == "gat_bwd_rev":
            csr = is_, cs
        args = {"gat_softmax": (ES.gat_softmax_plain,
                                (ir, cr, pi, pj, v, SLOPE)),
                "gat_bwd_dpi": (ES.gat_bwd_dpi_plain,
                                csr + (pi, pj, v, mx, den, s_n, dy, SLOPE)),
                "gat_bwd_rev": (ES.gat_bwd_rev_plain,
                                csr + (pi, pj, v, mx, den, s_n, dy,
                                       SLOPE))}[case]
    fn, a = args
    got = fn(*a)
    want = fn(*[t.float() if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t for t in a])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (gt, wt) in enumerate(zip(got, want)):
        if wt.dtype == torch.float32 and gt.dtype == torch.float32:
            assert torch.equal(gt, wt), i       # softmax state
        else:
            assert gt.dtype == torch.bfloat16, i
            assert torch.equal(gt, wt.to(torch.bfloat16)), i


def test_finalize_softmax_returns_num_dtype():
    """A bfloat16 num over the float32 state: out in bfloat16 (divided in
    float32, rounded once), mx and den float32, with and without the self
    loop (JAX ``_finalize_softmax``, ``edge_softmax.py:1729, 1743``)."""
    rng = np.random.default_rng(3)

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(dtype)
    num, m, s = t(7, 2, 3, dtype=torch.bfloat16), t(7, 2), t(7, 2).abs()
    for self_terms in (None, (t(7, 2, dtype=torch.bfloat16),
                              t(7, 2, 3, dtype=torch.bfloat16))):
        extra = self_terms or (None, None)
        out, mx, den = ES.finalize_softmax(num, m, s, *extra)
        assert out.dtype == torch.bfloat16
        assert mx.dtype == den.dtype == torch.float32
        ref, _, _ = ES.finalize_softmax(num.float(), m, s, *(
            None if a is None else a.float() for a in extra))
        assert torch.equal(out, ref.to(torch.bfloat16))


def test_gatv2_backward_takes_s_n_in_float32(monkeypatch):
    """GatV2AttentionFunction's backward hands K10 and K11 ``s_n`` in
    float32 for bfloat16 rows (JAX ``edge_softmax.py:1545-1547``), and
    returns every gradient in its primal's type."""
    seen = []
    for name in ("gatv2_bwd_dq", "gatv2_bwd_rev"):
        def spy(*args, real=getattr(ES, name), name=name):
            seen.append((name, args[7].dtype))        # s_n
            return real(*args)
        monkeypatch.setattr(ES, name, spy)
    rng = np.random.default_rng(5)
    g = tgnn.rand_graph(30, 120, seed=5, device="cpu")

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(
            torch.bfloat16).requires_grad_()
    ins = [bf(30, 2, 4), bf(30, 2, 4), bf(4, 2), bf(30, 2), bf(30, 2, 4)]
    out = ES.gatv2_attention_nodes(g, *ins[:3], SLOPE, self_logits=ins[3],
                                   self_values=ins[4])
    out.float().sum().backward()
    assert seen == [("gatv2_bwd_dq", torch.float32),
                    ("gatv2_bwd_rev", torch.float32)]
    assert all(t.grad.dtype == torch.bfloat16 for t in ins)


def test_gat_backward_takes_s_n_in_float32(monkeypatch):
    """GatAttentionFunction's backward hands K4 and K5 ``s_n`` in float32
    for bfloat16 rows (JAX ``edge_softmax.py:1121``), and returns every
    gradient in its primal's type."""
    seen = []
    real = ES.gat_bwd_dpi

    def spy(*args):
        seen.append(args[7].dtype)        # s_n
        return real(*args)
    monkeypatch.setattr(ES, "gat_bwd_dpi", spy)
    rng = np.random.default_rng(4)
    g = tgnn.rand_graph(30, 120, seed=4, device="cpu")

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(
            torch.bfloat16).requires_grad_()
    ins = [bf(30, 2), bf(30, 2), bf(30, 2, 4), bf(30, 2), bf(30, 2, 4)]
    out = ES.gat_attention_nodes(g, *ins[:3], SLOPE, self_logits=ins[3],
                                 self_values=ins[4])
    out.float().sum().backward()
    assert seen == [torch.float32]
    assert all(t.grad.dtype == torch.bfloat16 for t in ins)


# ---- Precision -----------------------------------------------------------

def _jax_model():
    inner = JM.GNNChain(JM.GCNConv(8, 16, jax.nn.relu, rngs=nnx.Rngs(0)),
                        JM.GATConv(16, 4, heads=2, rngs=nnx.Rngs(1)))
    return JM.Precision(inner)


@pytest.mark.parametrize("seed", [0, 1])
def test_precision_matches_jax(seed):
    """JAX's Precision test model (``test_basics_plumbing.py:181-200``),
    carried into the port's Precision by load_jax_params (the JAX state
    nests under ``module``): bfloat16 output within 10 u of max |out| of
    JAX's, float32 finite gradients within 10 u by norm."""
    jg = jgnn.rand_graph(80, 400, seed=seed, build_spmm_aux=True)
    ne = int(jg.num_edges)
    tg = tgnn.graph(np.asarray(jg.senders)[:ne],
                    np.asarray(jg.receivers)[:ne], num_nodes=80,
                    device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (jg.n_pad, 8)).astype(np.float32)
    jm = _jax_model()
    gd, st = nnx.split(jm)

    def loss(st):
        out = nnx.merge(gd, st)(jg, jnp.asarray(x))[:80]
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jy), jgrads = jax.value_and_grad(loss, has_aux=True)(st)
    tm = TM.Precision(TM.GNNChain(
        TM.GCNConv(8, 16, torch.relu, device="cpu"),
        TM.GATConv(16, 4, heads=2, device="cpu")))
    load_jax_params(tm, pure_params(jm))
    ty = tm(tg, torch.tensor(x[:80]))
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    got, want = _np(ty), _np(jy)
    assert np.max(np.abs(got - want)) <= 10 * U * np.max(np.abs(want))
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(jgrads)))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 ref.named_parameters()):
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        a, b = p.grad.double(), q.detach().double()
        assert float((a - b).norm() / b.norm()) <= 10 * U, name


def test_precision_casts_inputs_not_graph():
    """Floating tensors in x, args and kw (nested too) reach the module in
    bfloat16, integer ones and the graph as they are; the parameters keep
    their float32 storage."""
    seen = {}

    class Probe(TM.GNNLayer):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))
            self.register_buffer("b", torch.zeros(3))

        def forward(self, g, x, extra, *, kw):
            seen.update(g=g, x=x, extra=extra, kw=kw, w=self.w, b=self.b)
            return x[0] * self.w + self.b

    g = tgnn.rand_graph(5, 10, seed=0, device="cpu")
    model = TM.Precision(Probe())
    idx = torch.arange(3)
    y = model(g, (torch.ones(3), idx), [torch.ones(2)],
              kw={"a": torch.ones(1, dtype=torch.float64)})
    assert seen["g"] is g
    assert seen["x"][0].dtype == torch.bfloat16 and seen["x"][1] is idx
    assert seen["extra"][0].dtype == torch.bfloat16
    assert seen["kw"]["a"].dtype == torch.bfloat16
    assert seen["w"].dtype == seen["b"].dtype == torch.bfloat16
    y.float().sum().backward()
    assert model.module.w.dtype == model.module.w.grad.dtype == torch.float32


# ---- the kernels refuse a mix of types ----------------------------------

@pytest.mark.parametrize("case", ["K1 w", "K3 pi", "K4 mx", "K5 dy", "K2 w",
                                  "K12 mask", "K13 xj", "K14 dy", "K9 q",
                                  "K10 dy", "K11 mx", "K6 v", "K7 dy",
                                  "K8 mx"])
def test_bf16_kernels_refuse_a_mix_of_types(case):
    """K1's and K2's rows and weights, GAT's, GATv2's, dot attention's and
    K12's rows and scalars, K13's two row tables and K14's operands are all
    float32 or all bfloat16; the softmax state (and K6's raw logits)
    float32. A mix raises."""
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    ir, cr, is_, cs, es = g.indptr_r, g.col_r, g.indptr_s, g.col_s, g.eid_s
    b, f = torch.bfloat16, torch.float32

    def z(*shape, dtype=b):
        return torch.zeros(shape, dtype=dtype)
    bwd = dict(pi=z(16, 2), pj=z(16, 2), values_n=z(16, 2, 4),
               mx=z(16, 2, dtype=f), den=z(16, 2, dtype=f),
               s_n=z(16, 2, dtype=f), dy=z(16, 2, 4))
    v2 = dict(q=z(16, 2, 4), k=z(16, 2, 4), a=z(4, 2), mx=z(16, 2, dtype=f),
              den=z(16, 2, dtype=f), s_n=z(16, 2, dtype=f), dy=z(16, 2, 4))
    dot = dict(q=z(16, 2, 4), k=z(16, 2, 4), v=z(16, 2, 6),
               mx=z(16, 2, dtype=f), den=z(16, 2, dtype=f),
               s_n=z(16, 2, dtype=f), dy=z(16, 2, 6), raw=z(40, 2, dtype=f))
    with pytest.raises(TypeError):
        if case == "K1 w":
            S._check_launch(ir, cr, None, z(40, dtype=f), z(16, 4))
        elif case == "K3 pi":
            ES._check_launch(ir, cr, {"pi": z(16, 2, dtype=f),
                                      "pj": z(16, 2)},
                             {"values_n": z(16, 2, 4)})
        elif case == "K4 mx":
            ES._gat_bwd_args(ir, cr, **{**bwd, "mx": z(16, 2)})
        elif case == "K5 dy":
            ES._gat_bwd_args(ir, cr, **{**bwd, "dy": z(16, 2, 4, dtype=f)})
        elif case == "K2 w":
            S._check_sddmm(is_, cs, es, z(40, dtype=f), z(16, 4), z(16, 4))
        elif case == "K12 mask":
            ES._check_launch(ir, cr, {"logits": z(40, 2),
                                      "mask": z(40, 2, dtype=f)},
                             {"values": z(16, 2, 4)})
        elif case == "K13 xj":
            SD._sddmm_kernel(ir, cr, z(16, 2, 4), z(16, 2, 4, dtype=f))
        elif case == "K9 q":
            ES._gatv2_args(ir, cr, z(16, 2, 4, dtype=f), z(16, 2, 4),
                           z(4, 2), {}, {})
        elif case == "K10 dy":
            ES._gatv2_bwd_args(ir, cr, **{**v2, "dy": z(16, 2, 4, dtype=f)})
        elif case == "K11 mx":
            ES._gatv2_bwd_args(is_, cs, **{**v2, "mx": z(16, 2)})
        elif case == "K6 v":
            ES._dot_args(ir, cr, dot["q"], dot["k"], z(16, 2, 6, dtype=f),
                         {"raw_out": dot["raw"]}, {}, {})
        elif case == "K7 dy":
            ES._dot_bwd_args(ir, cr, **{**dot, "dy": z(16, 2, 6, dtype=f)})
        elif case == "K8 mx":
            ES._dot_bwd_args(is_, cs, **{**dot, "mx": z(16, 2),
                                         "raw": None})
        else:
            SG._check_launch(ir, z(40, 4), z(16, 4), z(16, 4, dtype=f))
    # the same operands, all of one type, pass
    S._check_launch(ir, cr, None, z(40), z(16, 4))
    ES._gat_bwd_args(ir, cr, **bwd)
    ES._gatv2_bwd_args(ir, cr, **v2)
    ES._dot_bwd_args(ir, cr, **dot)
    ES._dot_args(ir, cr, dot["q"], dot["k"], dot["v"],
                 {"raw_out": dot["raw"]}, {}, {})
    S._check_sddmm(is_, cs, es, z(40), z(16, 4), z(16, 4))
    ES._check_launch(ir, cr, {"logits": z(40, 2), "mask": z(40, 2)},
                     {"values": z(16, 2, 4)})
    assert SG._check_launch(ir, z(40, 4), z(16, 4), z(16, 4))


# ---- degree counts in the requested dtype --------------------------------
#
# The JAX package counts an unweighted degree, and its kernel-path mean's
# divisor, as a sum of ones in the requested dtype; a bfloat16 sum of ones
# stops at 256 (256 + 1 rounds back to 256). The port clamps its exact
# integer count there (``ops.segment.count_as``). Star graphs put one hub
# at in-degree 255, 256, 257 and 1,099, beside extra edges among the
# leaves.

STAR_DEGREES = [255, 256, 257, 1099]


def _star(k, extra, seed):
    """Node 0 receives one edge from each of nodes 1..k; ``extra`` random
    edges join the leaves."""
    rng = np.random.default_rng(seed)
    n = k + 1
    s = np.concatenate([np.arange(1, n), rng.integers(1, n, extra)])
    r = np.concatenate([np.zeros(k, np.int64), rng.integers(1, n, extra)])
    return s, r, n


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("k", STAR_DEGREES)
def test_star_degree_matches_jax(k, dtype):
    """``degree`` in every direction equals JAX's sum of ones in the dtype
    exactly (bfloat16 stops at 256; float16 at 2048, past these counts),
    and so does a literal sum of ones in the dtype by ``index_add`` (the
    port's ``segment_sum``), the other way to count."""
    s, r, n = _star(k, 40, k)
    jg, tg = graph_pair(s, r, n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for d in ("in", "out", "both"):
        got = tgnn.degree(tg, dir=d, dtype=td)
        assert got.dtype == td
        want = _np(jgnn.degree(jg, dir=d, dtype=jd)[:n])
        np.testing.assert_array_equal(_np(got), want, err_msg=d)
        if d == "in":
            literal = torch.zeros(n, dtype=td).index_add_(
                0, tg.receivers, torch.ones(tg.num_edges, dtype=td))
            np.testing.assert_array_equal(_np(literal), want)
            assert _np(got)[0] == (min(k, 256) if dtype == "bfloat16"
                                   else k)


@pytest.mark.parametrize("k", STAR_DEGREES)
def test_star_propagate_mean_matches_jax_kernel_path(monkeypatch, k):
    """``propagate(copy_xj, mean)`` in bfloat16 against JAX's kernel path
    (its size gate lowered to 0, as ``tests/test_pallas_spmm.py:157``
    does), which divides the Pallas sum by a bfloat16 count. Integer rows
    make every float32 sum exact, so the forward is held bit for bit (the
    all-ones column gives the hub ``round(k) / 256`` past 256); the
    gradient within one bfloat16 ulp plus the float32 tolerance."""
    from graphneuralnetworks_tpu.ops import msgpass as JMP
    monkeypatch.setattr(JMP, "_MEAN_KERNEL_MIN_EDGES", 0)
    s, r, n = _star(k, 60, k + 1)
    jg, tg = graph_pair(s, r, n, aux=True)
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, (n, 5)).astype(np.float32)
    x[:, 0] = 1.0
    cot = rng.integers(-2, 3, (n, 5)).astype(np.float32)
    jx, tx = _pair(pad_rows(x, jg.n_pad))
    tx = tx[:n].requires_grad_()

    def jloss(xp):
        y = jops.propagate(jops.copy_xj, jg, "mean", xj=xp)
        return jnp.sum(y[:n].astype(jnp.float32) * cot), y[:n]

    (_, jy), jdx = jax.value_and_grad(jloss, has_aux=True)(jx)
    ty = tops.propagate(tops.copy_xj, tg, "mean", xj=tx)
    (ty.float() * torch.tensor(cot)).sum().backward()
    assert ty.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))
    hub = float(torch.tensor(float(k)).to(torch.bfloat16)) / min(k, 256)
    assert float(ty[0, 0].detach()) == hub
    got, want = _np(tx.grad), _np(jdx[:n])
    tol = _bf16_ulp(want) + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


def test_precision_gcn_on_a_star_matches_jax(monkeypatch):
    """``Precision(GCNConv(8, 8))`` with JAX's parameters on the star of
    in-degree 1,099: JAX normalises the hub by ``rsqrt(256 + 1)`` rounded
    to bfloat16, and so must the port. Each output is held within 10 u of
    S = |m| @ |W| (m the normalised aggregate): each side rounds ``x * c``,
    the sum, ``agg + x``, ``* c`` and the product at most u of S each (the
    bias is 0). Counting exactly, as the port did, moves the hub row by a
    factor of sqrt(1100 / 257) = 2.07, far outside that."""
    s, r, n = _star(1099, 60, 3)
    jg, tg = graph_pair(s, r, n, aux=True)
    x = np.random.default_rng(3).standard_normal((n, 8)).astype(np.float32)
    jm = JM.Precision(JM.GCNConv(8, 8, rngs=nnx.Rngs(4)))
    jy = _np(jm(jg, jnp.asarray(pad_rows(x, jg.n_pad)))[:n])
    tm = load_jax_params(TM.Precision(TM.GCNConv(8, 8, device="cpu")),
                         pure_params(jm))
    m = _np(tm(tg, torch.tensor(x), conv_weight=torch.eye(8)))
    W = tm.module.weight.detach().double().numpy()
    tol = 10 * U * (np.abs(m) @ np.abs(W)) + 1e-6

    def port():
        return _np(tm(tg, torch.tensor(x)))

    assert np.all(np.abs(port() - jy) <= tol)
    monkeypatch.setattr(tgnn.query, "count_as", lambda c, d: c.to(d))
    exact = port()
    assert not np.all(np.abs(exact - jy)[0] <= tol[0])
    ratio = np.abs(jy[0]).sum() / np.abs(exact[0]).sum()
    assert abs(ratio - np.sqrt(1100 / 257)) < 0.05


def test_precision_drops_batchnorm_running_stats():
    """A BatchNorm called in training mode inside Precision keeps its
    initial running statistics on both sides: JAX updates a merged copy
    (``nnx.merge(gd, low)``), the port the bfloat16 copies that
    ``functional_call`` swaps in. The same call outside Precision moves
    them."""
    class JProbe(nnx.Module):
        def __init__(self):
            self.bn = nnx.BatchNorm(4, rngs=nnx.Rngs(0))

        def __call__(self, g, x):
            return self.bn(x, use_running_average=False)

    class TProbe(TM.GNNLayer):
        def __init__(self):
            super().__init__()
            self.bn = TM.BatchNorm(4, device="cpu")

        def forward(self, g, x):
            return self.bn(x, use_running_average=False)

    jg, tg, _ = _graphs(5)
    x = np.random.default_rng(5).standard_normal((N, 4)).astype(np.float32)
    x += 3.0
    jm, tm = JM.Precision(JProbe()), TM.Precision(TProbe())
    jy = jm(jg, jnp.asarray(pad_rows(x, jg.n_pad))[:N])
    ty = tm(tg, torch.tensor(x))
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    bn = tm.module.bn
    for stat, init in (("mean", 0.0), ("var", 1.0)):
        np.testing.assert_array_equal(
            np.asarray(getattr(jm.module.bn, stat)[...]), np.full(4, init))
        np.testing.assert_array_equal(
            getattr(bn, f"running_{stat}").numpy(), np.full(4, init))
    tm.module(tg, torch.tensor(x))
    assert np.all(bn.running_mean.numpy() > 0.01)
