"""bfloat16 on K2, K12, K13, K14 (and its backward) and on the endpoint
gathers' backward (K1 over edge rows), against the JAX package on the CPU,
and the five ``Precision`` models these kernels serve.

The JAX side runs as its own tests run it, under ``jax.jit``: graphs built
with ``build_spmm_aux=True`` (N <= 128 nodes, E <= 512 edges: one Pallas
block, ``BN = 128``, ``BE = 512``), so its attention, SDDMM, SpMM and
gather backward go through the Pallas kernels in interpret mode; its
segment max is XLA's. Inputs are made with numpy in float32 and cast to
bfloat16 on both sides (``_pair``: the same bits). The port runs each case
by its plain route and, where the card would take a kernel, by the card's
autograd functions on CPU tensors (``kernels``: ``_kernel_route``
monkeypatched to True; their kernels take the plain versions here).

Tolerances, with bfloat16's unit roundoff u = 2^-8 (a rounding to nearest
moves a value by at most u times its size; one ulp is 2u), against S, the
same sum over the absolute values of its terms (float64, from the bfloat16
inputs), plus 1e-5 S + 1e-6 for the float32 sums' order:

- ``attention_aggregate`` (K12; its backward K2 for node values, eager for
  edge values): the forward as GAT's (``test_torch_precision.py``): the
  port rounds ``num`` and ``out``, JAX also each weight ``p * mask``
  before its dot (``edge_softmax.py:274``): 5 u S. The node values'
  gradient: both sides round the weights ``mask * alpha`` to bfloat16 for
  the scatter (JAX's ``spmm.py:327``, the port's K2 operand), from float32
  weights that differ in their last bits, and round one float32 sum: 4 u
  S. The edge values' gradient: one float32 product rounded on each side,
  2 u S. The logits' and the self logits' gradients take ``s_n = <out,
  dy>`` per receiver: each side's forward error (5 u S_out together), a
  bfloat16 product and sum on each side (4 u), and ``<v, dy>`` (JAX's
  products and sum, the port's one rounding: 3 u, below the 4 u of s_n),
  then the final rounding on each side (2 u): 11 u S. The self values'
  gradient 2 u S.
- ``dot_attention_logits`` / ``apply_edges(xi_dot_xj)`` (K13, whose
  backward is K1 twice) and ``fast_gather``'s backward (K1 over edge rows):
  each output is one float32 sum of exact products of bfloat16 values on
  both sides (the cotangent's bits are the same), rounded once, in another
  order: one bfloat16 ulp of the result plus the float32 tolerance.
- ``aggregate_neighbors(max)`` and ``GlobalPool("max")`` (K14 and its
  backward) on values on a grid of 1/4 (exact ties): a max picks one of its
  inputs, bit for bit. The gradient splits ``dy`` evenly over a row's ties:
  the port divides once (a bfloat16 division), JAX's scatter-max gradient
  may round the tie count's reciprocal and then the product, so the two
  land at most one bfloat16 ulp apart.
- The ``Precision`` models, each carried over by ``load_jax_params`` and
  held as ``test_precision_matches_jax`` holds GCN -> GAT: the two sides
  round the same values at the same points except where a float32 sum is
  taken in another order (a dense product, a propagation, a degree, an
  attention sum: one ulp, 2u, each) or JAX rounds more (the attention
  weights, u; its bfloat16 endpoint products, u). Counted on a path
  through a layer, with the layers' gains about 1, they put the output
  within k u of max |out| and each parameter gradient within k u by norm:
  GCN with learned edge weights, per layer the weighted degree (twice
  through ``c = rsqrt(deg + 1)``: 2 u), the SpMM and the dense product:
  k = 12; GAT with attention dropout, per layer the dense product, ``pi``
  and ``pj`` (2 u) and the attention (5 u): k = 18; GCN + ``DotDecoder``,
  the encoder's 2 x (SpMM, product) = 8 u on each endpoint's row, twice in
  a dot, and the decoder's sum (2 u) and JAX's products (u): k = 19 of
  the scores' S; EdgeConv (max), per layer the MLP's product (the maxima
  and ties are the same bits on both sides where the messages are): k =
  4; graph classification with ``GlobalPool("max")``, per ``GraphConv``
  two products and the SpMM (6 u), the head's product: k = 14.
"""

import copy

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu import data as jdata  # noqa: E402
from graphneuralnetworks_tpu import models as JM  # noqa: E402
from graphneuralnetworks_tpu import ops as jops  # noqa: E402
from graphneuralnetworks_tpu.models import conv as JC  # noqa: E402
from graphneuralnetworks_tpu.ops import attention as JA  # noqa: E402
from graphneuralnetworks_tpu.ops.pallas.sddmm import sddmm as jsddmm  # noqa: E402
from graphneuralnetworks_tpu_torch import data as tdata  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetworks_tpu_torch.interop import load_jax_params  # noqa: E402
from graphneuralnetworks_tpu_torch.models import conv as TC  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import attention as TA  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import msgpass as TMP  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as TSEG  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG  # noqa: E402
from torch_parity import graph_pair, pad_rows, pure_params  # noqa: E402

U = 2.0 ** -8                      # bfloat16's unit roundoff
N, E = 100, 400                    # one Pallas block: N <= 128, E <= 512
KEEP = 2.5                         # a kept weight's dropout scale, p = 0.6


def _np(t):
    """A bfloat16 (or float) array of either package as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _bf16_ulp(a):
    """One bfloat16 ulp at each |a| (the smallest normal's at 0)."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _pair(a):
    """float32 numpy -> (JAX bfloat16, the port's bfloat16), the same
    bits."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _graphs(seed):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    jg, tg = graph_pair(s, r, N, aux=True, dtype=np.float32)
    assert jg.n_pad <= 128 and jg.e_pad <= 512
    return jg, tg, rng


def _within(name, got, want, scale, k):
    got, want = _np(got), _np(want)
    tol = k * U * scale + 1e-5 * scale + 1e-6
    err = np.abs(got - want)
    assert np.all(err <= tol), (name, float(np.max(err / tol)))


def _within_ulp(name, got, want):
    got, want = _np(got), _np(want)
    tol = _bf16_ulp(want) + 1e-5 + 1e-5 * np.abs(want)
    err = np.abs(got - want)
    assert np.all(err <= tol), (name, float(np.max(err / tol)))


def _masks(rng, rows, heads):
    """Dropout scales of p = 0.6: 0 or 2.5, exact in bfloat16."""
    return (rng.random((rows, heads)) < 0.4).astype(np.float32) * KEEP


# ---- K12: attention_aggregate ---------------------------------------------

def _attention_scales(tg, lg, v, sl, sv, me, ms, dy, node_values):
    """S of ``out`` and of each gradient (module docstring), in float64
    from the bfloat16 values."""
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    n, ne = tg.num_nodes, tg.num_edges
    mx = np.full((n, lg.shape[1]), -np.inf)
    np.maximum.at(mx, r, lg)
    mx = np.where(np.isneginf(mx), 0.0, np.maximum(mx, sl))
    ex = np.exp(lg - mx[r])
    den = np.zeros(mx.shape)
    np.add.at(den, r, ex)
    ex_self = np.exp(sl - mx)
    den = np.maximum(den + ex_self, np.finfo(np.float32).tiny)
    alpha, a_self = ex / den[r], ex_self / den
    v_e = np.abs(v[s] if node_values else v)
    s_out = (a_self * ms)[..., None] * np.abs(sv)
    np.add.at(s_out, r, (alpha * me)[..., None] * v_e)
    sn_abs = np.sum(s_out * np.abs(dy), -1)
    s_dl = alpha * (me * np.sum(v_e * np.abs(dy[r]), -1) + sn_abs[r])
    dv_e = (alpha * me)[..., None] * np.abs(dy[r])
    if node_values:
        s_dv = np.zeros(v.shape)
        np.add.at(s_dv, s, dv_e)
    else:
        s_dv = dv_e
    s_dsl = a_self * (ms * np.sum(np.abs(sv * dy), -1) + sn_abs)
    s_dsv = (a_self * ms)[..., None] * np.abs(dy)
    assert s_dl.shape[0] == ne
    return s_out, [s_dl, s_dv, s_dsl, s_dsv]


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("values,masked,heads,d", [
    ("node", True, 2, 8), ("node", False, 1, 13), ("edge", True, 2, 8),
    ("edge", False, 1, 12)])
def test_attention_aggregate_bf16_matches_pallas(monkeypatch, route, values,
                                                 masked, heads, d):
    """attention_aggregate on bfloat16 logits, values and dropout masks,
    with the virtual self-loop, forward and every gradient, against the
    Pallas K12 (``edge_softmax_aggregate_nodes`` / ``_aggregate``) within
    the module docstring's bounds; outputs and gradients in their inputs'
    types. The same masks on both sides (float32 for JAX, as its GATConv
    draws them; bfloat16 for the port: the same values)."""
    if route == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    node_values = values == "node"
    jg, tg, rng = _graphs(11 + heads + d + 2 * node_values)
    ne = tg.num_edges
    vrows = jg.n_pad if node_values else jg.e_pad
    raw = [rng.standard_normal((jg.e_pad, heads)),
           rng.standard_normal((vrows, heads, d)),
           rng.standard_normal((jg.n_pad, heads)),
           rng.standard_normal((jg.n_pad, heads, d))]
    pairs = [_pair(a) for a in raw]
    me = _masks(rng, jg.e_pad, heads) if masked else np.ones(
        (jg.e_pad, heads), np.float32)
    ms = _masks(rng, jg.n_pad, heads) if masked else np.ones(
        (jg.n_pad, heads), np.float32)
    cot = rng.standard_normal((N, heads, d)).astype(np.float32)

    def jloss(lg, v, sl, sv):
        out = JA.attention_aggregate(
            jg, lg, v, self_logits=sl, self_values=sv,
            dropout_masks=(jnp.asarray(me), jnp.asarray(ms)) if masked
            else None, node_values=node_values)[:N]
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*[p[0] for p in pairs])
    rows = [ne, N if node_values else ne, N, N]
    targs = [p[1][:k].clone().requires_grad_() for p, k in zip(pairs, rows)]
    dm = ((torch.tensor(me[:ne]).bfloat16(), torch.tensor(ms[:N]).bfloat16())
          if masked else None)
    tout = TA.attention_aggregate(tg, targs[0], targs[1],
                                  self_logits=targs[2], self_values=targs[3],
                                  dropout_masks=dm, node_values=node_values)
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16

    vals = [_np(t.detach()) for t in targs]
    dy = _np(torch.tensor(cot).bfloat16())
    s_out, s_grads = _attention_scales(tg, vals[0], vals[1], vals[2],
                                       vals[3], me[:ne].astype(np.float64),
                                       ms[:N].astype(np.float64), dy,
                                       node_values)
    _within("out", tout, jout, s_out, 5)
    names, ks = ["dl", "dv", "dsl", "dsv"], [11, 4 if node_values else 2,
                                             11, 2]
    for name, k, t, jgrad, sc, n in zip(names, ks, targs, jgrads, s_grads,
                                        rows):
        assert t.grad.dtype == torch.bfloat16, name
        _within(name, t.grad, jgrad[:n], sc, k)


def test_edge_softmax_nodes_backward_hands_k2_bf16_weights(monkeypatch):
    """EdgeSoftmaxNodesFunction's backward gives K2 the weights ``mask *
    alpha`` in the values' type (JAX rounds them so at its scatter) and
    the rows and cotangent as they are: one all-bfloat16 call."""
    seen = []
    real = ES.spmm_sddmm

    def spy(*args):
        seen.append(tuple(a.dtype for a in args[3:]))
        return real(*args)
    monkeypatch.setattr(ES, "spmm_sddmm", spy)
    rng = np.random.default_rng(3)
    g = tgnn.rand_graph(30, 120, seed=3, device="cpu")

    def bf(*shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).bfloat16().requires_grad_()
    lg, v = bf(120, 2), bf(30, 2, 4)
    masks = (torch.full((120, 2), KEEP).bfloat16(), None)
    out = ES.edge_softmax_aggregate_nodes(g, lg, v, dropout_masks=masks)
    out.float().sum().backward()
    assert seen == [(torch.bfloat16,) * 3]
    assert lg.grad.dtype == v.grad.dtype == torch.bfloat16


# ---- K13: dot_attention_logits, apply_edges(xi_dot_xj) ---------------------

@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("heads,d", [(1, 8), (1, 13), (2, 12)])
def test_dot_attention_logits_bf16_matches_pallas(monkeypatch, route, heads,
                                                  d):
    """dot_attention_logits on bfloat16 ``[N, H, D]`` rows, forward and both
    gradients, against JAX's Pallas ``sddmm`` per head (K13 forward, its
    K1 scatter backward) within one bfloat16 ulp plus the float32
    tolerance."""
    if route == "kernels":
        monkeypatch.setattr(TA, "_kernel_route", lambda t: True)
    jg, tg, rng = _graphs(21 + heads + d)
    ne = tg.num_edges
    (jq, tq), (jk, tk) = (_pair(rng.standard_normal((jg.n_pad, heads, d)))
                          for _ in range(2))
    cot = rng.standard_normal((ne, heads)).astype(np.float32)

    def jloss(q, k):
        out = jnp.stack([jsddmm(q[:, h], k[:, h], jg.spmm_aux, (jg.e_pad,))
                         for h in range(heads)], axis=1)[:ne]
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jdq, jdk) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jq, jk)
    tq, tk = tq[:N].clone().requires_grad_(), tk[:N].clone().requires_grad_()
    tout = TA.dot_attention_logits(tg, tq, tk)
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert tout.dtype == tq.grad.dtype == tk.grad.dtype == torch.bfloat16
    for name, got, want in (("out", tout, jout), ("dq", tq.grad, jdq[:N]),
                            ("dk", tk.grad, jdk[:N])):
        _within_ulp(name, got, want)


def test_apply_edges_xi_dot_xj_bf16_matches_pallas(monkeypatch):
    """apply_edges(xi_dot_xj) of two bfloat16 ``[N, D]`` tables on the
    card's route (one SDDMM) at D = 300, where JAX's apply_edges takes its
    Pallas kernel too: ``[E, 1]`` scores and both gradients within one
    bfloat16 ulp plus the float32 tolerance."""
    monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    jg, tg, rng = _graphs(5)
    ne, d = tg.num_edges, 300
    (jx, tx), (jy, ty) = (_pair(rng.standard_normal((jg.n_pad, d)))
                          for _ in range(2))
    cot = rng.standard_normal((ne, 1)).astype(np.float32)

    def jloss(x, y):
        out = jops.apply_edges(jops.xi_dot_xj, jg, xi=x, xj=y)[:ne]
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jdx, jdy) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jx, jy)
    tx, ty = tx[:N].clone().requires_grad_(), ty[:N].clone().requires_grad_()
    before = dict(SD.launches)
    tout = tops.apply_edges(tops.xi_dot_xj, tg, xi=tx, xj=ty)
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert SD.launches == before     # CPU tensors take the plain version
    assert tout.shape == (ne, 1) and tout.dtype == torch.bfloat16
    for name, got, want in (("out", tout, jout), ("dxi", tx.grad, jdx[:N]),
                            ("dxj", ty.grad, jdy[:N])):
        _within_ulp(name, got, want)


# ---- K1 over edge rows: fast_gather's backward -----------------------------

@pytest.mark.parametrize("width", [8, 13])
def test_gather_backward_bf16_matches_pallas(width):
    """apply_edges' endpoint gathers (``fast_gather``) of bfloat16 node
    rows: the backward, a scatter of bfloat16 edge rows onto their
    receivers and senders (K1 over edge rows on the card), against JAX's
    ``_fg_bwd`` (its Pallas scatter in ``dy``'s type), within one bfloat16
    ulp plus the float32 tolerance."""
    jg, tg, rng = _graphs(31 + width)
    ne = tg.num_edges
    (jx, tx) = _pair(rng.standard_normal((jg.n_pad, width)))
    cot = rng.standard_normal((ne, 2 * width)).astype(np.float32)

    def msg(xi, xj, e):
        return (jnp if isinstance(xi, jax.Array) else torch).concatenate(
            [xi, xj], -1)

    def jloss(x):
        out = jops.apply_edges(msg, jg, xi=x, xj=x)[:ne]
        return jnp.sum(out.astype(jnp.float32) * cot)

    jdx = jax.jit(jax.grad(jloss))(jx)
    tx = tx[:N].clone().requires_grad_()
    out = tops.apply_edges(msg, tg, xi=tx, xj=tx)
    (out.float() * torch.tensor(cot)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    _within_ulp("dx", tx.grad, jdx[:N])


# ---- K14: max aggregation and GlobalPool("max") ----------------------------

def _grid(rng, shape):
    """Values on a grid of 1/4: many exact ties, exact in bfloat16."""
    return (np.round(rng.standard_normal(shape) * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("width", [4, 8])
def test_aggregate_max_bf16_with_ties_matches_jax(monkeypatch, route, width):
    """aggregate_neighbors(max) of bfloat16 edge messages with exact ties:
    the maxima bit for bit, the gradient (split over the ties) within one
    bfloat16 ulp (module docstring)."""
    if route == "kernels":
        monkeypatch.setattr(TSEG, "_kernel_route", lambda t: True)
    jg, tg, rng = _graphs(41 + width)
    ne = tg.num_edges
    jm, tm = _pair(pad_rows(_grid(rng, (ne, width)), jg.e_pad))
    cot = rng.standard_normal((N, width)).astype(np.float32)

    def jloss(m):
        out = jops.aggregate_neighbors(jg, "max", m)[:N]
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jdm = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jm)
    tm = tm[:ne].clone().requires_grad_()
    before = dict(SG.launches)
    tout = tops.aggregate_neighbors(tg, "max", tm)
    (tout.float() * torch.tensor(cot)).sum().backward()
    assert SG.launches == before
    np.testing.assert_array_equal(_np(tout), _np(jout))
    assert tm.grad.dtype == torch.bfloat16
    _within_ulp("dm", tm.grad, jdm[:ne])
    hits = _np(tm) == _np(tout)[tg.receivers.numpy()]
    count = np.zeros((N, width))
    np.add.at(count, tg.receivers.numpy(), hits)
    assert np.sum(count >= 2) > 0          # the grid made ties


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_global_max_pool_bf16_with_ties_matches_jax(monkeypatch, route):
    """GlobalPool("max") over a batch of ``synthetic_tudataset`` graphs, in
    bfloat16 on a grid of 1/4 (exact ties): the pooled rows bit for bit,
    the gradient within one bfloat16 ulp."""
    if route == "kernels":
        monkeypatch.setattr(TSEG, "_kernel_route", lambda t: True)
    jb = next(iter(jdata.DataLoader(jdata.synthetic_tudataset(
        12, seed=2)[0], batch_size=12, shuffle=False)))
    tb = next(iter(tdata.DataLoader(tdata.synthetic_tudataset(
        12, seed=2, device="cpu")[0], batch_size=12, shuffle=False,
        device="cpu")))
    n = tb.num_nodes
    rng = np.random.default_rng(7)
    jx, tx = _pair(pad_rows(_grid(rng, (n, 6)), jb.x.shape[0]))
    cot = rng.standard_normal((12, 6)).astype(np.float32)
    jpool = JM.GlobalPool("max")

    def jloss(x):
        out = jpool(jb, x)[:12]
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jdx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jx)
    tx = tx[:n].clone().requires_grad_()
    tout = TM.GlobalPool("max")(tb, tx)
    (tout.float() * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(_np(tout), _np(jout))
    assert tx.grad.dtype == torch.bfloat16
    _within_ulp("dx", tx.grad, jdx[:n])


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("op_min", [False, True])
def test_segment_extreme_bf16_past_256_ties_matches_jax(monkeypatch, route,
                                                        op_min):
    """A segment max (min) of bfloat16 rows whose extreme ties 300 times
    in one segment and 3 times in another: the outputs bit for bit, and the
    gradient as JAX gives it, whose tie count (a scatter-add of ones in
    bfloat16) stops at 256: dy / 256 on each of the 300 ties, bit for bit,
    the rest within one bfloat16 ulp (module docstring)."""
    if route == "kernels":
        monkeypatch.setattr(TSEG, "_kernel_route", lambda t: True)
    rng = np.random.default_rng(17)
    sign = -1.0 if op_min else 1.0
    data = _grid(rng, (310, 4)) / 8
    data[:300, :3] = sign * 2.0            # 300 ties in columns 0-2
    data[300:303] = sign * 3.0             # 3 ties in the next segment
    ids = np.repeat(np.arange(3), [300, 3, 7]).astype(np.int32)
    cot = rng.standard_normal((4, 4)).astype(np.float32)
    jd, td = _pair(data)
    jfn = jops.segment_min if op_min else jops.segment_max

    def jloss(d):
        out = jfn(d, jnp.asarray(ids), 4)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jdd = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jd)
    td = td.clone().requires_grad_()
    tfn = tops.segment_min if op_min else tops.segment_max
    indptr = torch.tensor([0, 300, 303, 310, 310], dtype=torch.int32)
    tout = tfn(td, torch.tensor(ids, dtype=torch.long), 4, indptr=indptr)
    (tout.float() * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(_np(tout), _np(jout))
    assert td.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td.grad)[:300, :3], _np(jdd)[:300, :3])
    share = torch.tensor(cot[:1, :3]).bfloat16() / 256
    np.testing.assert_array_equal(_np(td.grad)[:300, :3],
                                  np.broadcast_to(_np(share), (300, 3)))
    _within_ulp("dd", td.grad, jdd)


# ---- the plain versions: bfloat16 is float32 rounded once ----------------

PLAIN_CASES = ["edge_softmax_nodes", "edge_softmax_nodes_mask",
               "edge_softmax_edges_mask", "sddmm", "segment_max",
               "segment_min", "segment_max_bwd"]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_versions_bf16_are_float32_rounded_once(case):
    """K12's, K13's and K14's plain versions on bfloat16 inputs give exactly
    their float32 result on the same (widened) values, rounded once to
    bfloat16; the softmax state exactly the float32 one; the max and min
    exactly (no rounding)."""
    rng = np.random.default_rng(PLAIN_CASES.index(case) + 50)
    g = tgnn.rand_graph(40, 160, seed=int(rng.integers(1000)), device="cpu")
    ir, cr = g.indptr_r, g.col_r

    def bf(*shape, grid=False):
        a = _grid(rng, shape) if grid else rng.standard_normal(shape)
        return torch.tensor(a, dtype=torch.float32).bfloat16()
    h, d = 2, 6
    if case.startswith("edge_softmax"):
        mask = (bf(160, h).abs() > 0.5).bfloat16() * KEEP if case.endswith(
            "mask") else None
        nodes = "nodes" in case
        fn = ES.edge_softmax_plain
        args = (ir, cr if nodes else None, bf(160, h), mask,
                bf(40 if nodes else 160, h, d))
    elif case == "sddmm":
        fn, args = SD.sddmm_plain, (ir, cr, bf(40, h, d), bf(40, h, d))
    elif case == "segment_max_bwd":
        data = bf(160, d, grid=True)
        out = SG.segment_max_plain(ir, data)
        fn, args = SG.segment_max_bwd_plain, (ir, data, out, bf(40, d))
    else:
        fn = getattr(SG, f"{case}_plain")
        args = (ir, bf(160, d, grid=True))
    got = fn(*args)
    want = fn(*[t.float() if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t for t in args])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (gt, wt) in enumerate(zip(got, want)):
        if gt.dtype == torch.float32:
            assert torch.equal(gt, wt), i       # softmax state
        else:
            assert gt.dtype == torch.bfloat16, i
            assert torch.equal(gt, wt.to(torch.bfloat16)), i
            if case.startswith("segment_m") and case != "segment_max_bwd":
                assert torch.equal(gt.float(), wt), i   # exact


# ---- the Precision models ---------------------------------------------------

def _hold(name, ty, jy, k, scale=None):
    got, want = _np(ty), _np(jy)
    scale = np.max(np.abs(want)) if scale is None else scale
    err = np.max(np.abs(got - want))
    assert err <= k * U * scale, (name, err / (k * U * scale))


def _hold_grads(tm, jgrads, k, extra=()):
    """Every float32 parameter gradient of ``tm`` within ``k u`` by norm of
    JAX's (carried over by load_jax_params); ``extra``: (port tensor, JAX
    gradient) pairs of inputs."""
    ref = load_jax_params(copy.deepcopy(tm), jax.tree.map(
        np.asarray, nnx.to_pure_dict(jgrads)))
    pairs = [(n, p.grad, q) for (n, p), (_, q) in zip(
        tm.named_parameters(), ref.named_parameters())]
    pairs += [(f"input {i}", t.grad, torch.tensor(np.asarray(g)))
              for i, (t, g) in enumerate(extra)]
    for name, a, b in pairs:
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        a, b = a.double(), b.detach().double()
        assert float((a - b).norm() / b.norm()) <= k * U, name


def _jax_step(jm, loss_of, *inputs):
    """JAX's output of ``loss_of(model, *inputs)`` and the gradients of
    the sum of its squares: the parameters', then each input's."""
    gd, st, rest = nnx.split(jm, nnx.Param, ...)

    def loss(st, *xs):
        out = loss_of(nnx.merge(gd, st, rest), *xs)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jy), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(inputs))), has_aux=True))(
        st, *inputs)
    return jy, grads[0], grads[1:]


def test_precision_gcn_learned_edge_weights_matches_jax():
    """``Precision(GNNChain(GCNConv, GCNConv))`` with learned edge weights
    (K1 and K2 in bfloat16 on the card): the output within 12 u of max
    |out|, every parameter's and the weights' gradient within 12 u by
    norm."""
    jg, tg, rng = _graphs(61)
    ne = tg.num_edges
    x = rng.standard_normal((jg.n_pad, 8)).astype(np.float32)
    w = (rng.random(jg.e_pad) + 0.5).astype(np.float32)
    jm = JM.Precision(JM.GNNChain(
        JM.GCNConv(8, 16, jax.nn.relu, rngs=nnx.Rngs(0)),
        JM.GCNConv(16, 4, rngs=nnx.Rngs(1))))
    jy, jgrads, (_, jdw) = _jax_step(
        jm, lambda m, xx, ww: m(jg, xx, edge_weight=ww)[:N],
        jnp.asarray(x), jnp.asarray(w))
    tm = load_jax_params(TM.Precision(TM.GNNChain(
        TM.GCNConv(8, 16, torch.relu, device="cpu"),
        TM.GCNConv(16, 4, device="cpu"))), pure_params(jm))
    tw = torch.tensor(w[:ne]).requires_grad_()
    ty = tm(tg, torch.tensor(x[:N]), edge_weight=tw)
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 12)
    _hold_grads(tm, jgrads, 12, [(tw, jdw[:ne])])


def test_precision_gat_dropout_matches_jax(monkeypatch):
    """``Precision(GNNChain(GATConv(heads=2), GATConv))`` with attention
    dropout 0.6 in training mode, both sides handed one set of masks (K12
    and K2 in bfloat16 on the card): the output within 18 u of max |out|,
    the gradients within 18 u by norm."""
    jg, tg, rng = _graphs(62)
    ne = tg.num_edges
    x = rng.standard_normal((jg.n_pad, 8)).astype(np.float32)
    masks = [(_masks(rng, jg.e_pad, h), _masks(rng, jg.n_pad, h))
             for h in (2, 1)]
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
    jm = JM.Precision(JM.GNNChain(
        JM.GATConv(8, 4, jax.nn.relu, heads=2, dropout=0.6,
                   rngs=nnx.Rngs(2)),
        JM.GATConv(8, 4, dropout=0.6, rngs=nnx.Rngs(3))))
    jy, jgrads, _ = _jax_step(
        jm, lambda m, xx: m(jg, xx, deterministic=False)[:N], jnp.asarray(x))
    tm = load_jax_params(TM.Precision(TM.GNNChain(
        TM.GATConv(8, 4, torch.relu, heads=2, dropout=0.6, device="cpu"),
        TM.GATConv(8, 4, dropout=0.6, device="cpu"))), pure_params(jm))
    ty = tm(tg, torch.tensor(x[:N]), deterministic=False)
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 18)
    _hold_grads(tm, jgrads, 18)


class _JLink(nnx.Module):
    def __init__(self):
        self.enc = JM.GNNChain(JM.GCNConv(8, 16, jax.nn.relu,
                                          rngs=nnx.Rngs(4)),
                               JM.GCNConv(16, 16, rngs=nnx.Rngs(5)))
        self.dec = JM.DotDecoder()

    def __call__(self, g, neg, x):
        h = self.enc(g, x)
        return jnp.concatenate([self.dec(g, h)[:, 0], self.dec(neg, h)[:, 0]])


class _TLink(TM.GNNLayer):
    def __init__(self):
        super().__init__()
        self.enc = TM.GNNChain(TM.GCNConv(8, 16, torch.relu, device="cpu"),
                               TM.GCNConv(16, 16, device="cpu"))
        self.dec = TM.DotDecoder()

    def forward(self, g, neg, x):
        h = self.enc(g, x)
        self.h = h.detach()
        return torch.cat([self.dec(g, h)[:, 0], self.dec(neg, h)[:, 0]])


def test_precision_link_prediction_matches_jax(monkeypatch):
    """``Precision`` over a GCN encoder and ``DotDecoder`` on the edges and
    on as many negatives (K13 and K1 in bfloat16 on the card; the port by
    the card's route, one SDDMM a decoder): the scores within 19 u of the
    largest ``sum |h_i h_j|``, the gradients within 19 u by norm."""
    monkeypatch.setattr(TMP, "_kernel_route", lambda t: True)
    jg, tg, rng = _graphs(63)
    jneg, tneg, _ = _graphs(64)
    ne, nn_ = tg.num_edges, tneg.num_edges
    x = rng.standard_normal((jg.n_pad, 8)).astype(np.float32)
    jm = JM.Precision(_JLink())

    def jcall(m, xx):
        out = m(jg, jneg, xx)
        return jnp.concatenate([out[:ne], out[jg.e_pad:jg.e_pad + nn_]])
    jy, jgrads, _ = _jax_step(jm, jcall, jnp.asarray(x))
    tm = load_jax_params(TM.Precision(_TLink()), pure_params(jm))
    ty = tm(tg, tneg, torch.tensor(x[:N]))
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    h = _np(tm.module.h)
    s = np.concatenate([np.abs(h[tg.receivers] * h[tg.senders]).sum(-1),
                        np.abs(h[tneg.receivers] * h[tneg.senders]).sum(-1)])
    _hold("scores", ty, jy, 19, scale=float(s.max()))
    _hold_grads(tm, jgrads, 19)


def test_precision_edgeconv_matches_jax():
    """``Precision(GNNChain(EdgeConv(MLP), relu, EdgeConv(MLP)))`` with max
    aggregation (K14 and its backward, K1 over edge rows in bfloat16 on the
    card): the output within 4 u of max |out|, the gradients within 4 u by
    norm."""
    jg, tg, rng = _graphs(65)
    x = rng.standard_normal((jg.n_pad, 6)).astype(np.float32)
    jm = JM.Precision(JM.GNNChain(
        JM.EdgeConv(JM.MLP([12, 8], rngs=nnx.Rngs(6))), jax.nn.relu,
        JM.EdgeConv(JM.MLP([16, 4], rngs=nnx.Rngs(7)))))
    jy, jgrads, _ = _jax_step(jm, lambda m, xx: m(jg, xx)[:N],
                              jnp.asarray(x))
    tm = load_jax_params(TM.Precision(TM.GNNChain(
        TM.EdgeConv(TM.MLP([12, 8], device="cpu")), torch.relu,
        TM.EdgeConv(TM.MLP([16, 4], device="cpu")))), pure_params(jm))
    ty = tm(tg, torch.tensor(x[:N]))
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("out", ty, jy, 4)
    _hold_grads(tm, jgrads, 4)


def test_precision_graph_classification_max_matches_jax():
    """examples/graph_classification.py's model with ``GlobalPool("max")``
    in ``Precision`` on a batch of ``synthetic_tudataset`` graphs (K1 and
    K14 over the graph CSR in bfloat16 on the card): the logits within 14 u
    of max |out|, the gradients within 14 u by norm."""
    jb = next(iter(jdata.DataLoader(jdata.synthetic_tudataset(
        16, seed=3)[0], batch_size=16, shuffle=False)))
    tb = next(iter(tdata.DataLoader(tdata.synthetic_tudataset(
        16, seed=3, device="cpu")[0], batch_size=16, shuffle=False,
        device="cpu")))
    r = nnx.Rngs(8)
    jm = JM.Precision(JM.GNNChain(
        JM.GraphConv(7, 16, jax.nn.relu, rngs=r),
        JM.GraphConv(16, 16, jax.nn.relu, rngs=r), JM.GlobalPool("max"),
        nnx.Linear(16, 2, rngs=r)))
    jy, jgrads, _ = _jax_step(jm, lambda m, xx: m(jb, xx)[:16],
                              jb.x.astype(jnp.float32))
    tm = load_jax_params(TM.Precision(TM.GNNChain(
        TM.GraphConv(7, 16, torch.relu, device="cpu"),
        TM.GraphConv(16, 16, torch.relu, device="cpu"),
        TM.GlobalPool("max"), torch.nn.Linear(16, 2))), pure_params(jm))
    ty = tm(tb, tb.x.float())
    (ty.float() ** 2).sum().backward()
    assert ty.dtype == torch.bfloat16
    _hold("logits", ty, jy, 14)
    _hold_grads(tm, jgrads, 14)
