"""Helpers for the parity tests between graphneuralnetworks_tpu (JAX) and
graphneuralnetworks_tpu_torch (PyTorch).

The same numpy graph and inputs feed both packages. The JAX side pads node
and edge arrays to its static capacities; results are compared on the first
``num_nodes`` rows and ``num_edges`` edges only.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

import graphneuralnetworks_tpu as jgnn
import graphneuralnetworks_tpu_torch as tgnn
from graphneuralnetworks_tpu_torch.interop import load_jax_params

# float64 against the XLA path: only summation order differs
F64_TOL = dict(rtol=1e-9, atol=1e-10)


def directed_graph_arrays(seed=3, n=50, n_active=40, e=160):
    """A directed multigraph on ``n`` nodes whose last ``n - n_active``
    nodes are isolated, with edge weights in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_active, e)
    r = rng.integers(0, n_active, e)
    w = rng.random(e) + 0.5
    return s, r, n, w


def graph_pair(s, r, n, w=None, *, aux=False, dtype=np.float64):
    """The same edges as a JAX GraphTuple and a port GraphTuple (CPU)."""
    w = None if w is None else np.asarray(w, dtype)
    jg = jgnn.graph(s, r, num_nodes=n, edge_weight=w, build_spmm_aux=aux)
    tg = tgnn.graph(s, r, num_nodes=n, edge_weight=w, device="cpu")
    return jg, tg


def pad_rows(a, n_pad):
    """Zero-pad the leading axis of a numpy array to ``n_pad`` rows."""
    a = np.asarray(a)
    return np.pad(a, [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def jax_params_f64(model):
    """Cast a JAX model's parameters to float64 in place."""
    state = nnx.state(model, nnx.Param)
    nnx.update(model, jax.tree.map(lambda a: a.astype(jnp.float64), state))
    return model


def pure_params(model):
    """``nnx.state(model, nnx.Param)`` as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(model, nnx.Param)))


def port_from_jax(module, jax_model):
    """Load the JAX model's parameters into the port module (in place)."""
    return load_jax_params(module, pure_params(jax_model))


def assert_grads_match(module, jax_grads, **tol):
    """Each ``.grad`` of ``module`` equals the JAX gradient of the same
    parameter (loaded through ``load_jax_params`` into a copy, which also
    transposes Dense kernels)."""
    ref = load_jax_params(copy.deepcopy(module), jax_grads)
    for (name, p), (_, q) in zip(module.named_parameters(),
                                 ref.named_parameters()):
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), q.detach().numpy(),
                                   err_msg=name, **tol)


def t(a, dtype=torch.float64, grad=False):
    """numpy -> CPU tensor."""
    out = torch.tensor(np.asarray(a), dtype=dtype)
    return out.requires_grad_() if grad else out


def assert_same_graph(jg, tg, *, weights_tol=None):
    """Counts, edges in stored order, node graph ids, weights and features
    of a JAX graph (its real rows) and a port graph, exactly (weights at
    ``weights_tol`` if given)."""
    nn, ne, ng = int(jg.num_nodes), int(jg.num_edges), int(jg.num_graphs)
    assert (tg.num_nodes, tg.num_edges, tg.num_graphs) == (nn, ne, ng)
    np.testing.assert_array_equal(tg.senders.numpy(),
                                  np.asarray(jg.senders)[:ne])
    np.testing.assert_array_equal(tg.receivers.numpy(),
                                  np.asarray(jg.receivers)[:ne])
    np.testing.assert_array_equal(tg.node_graph_id.numpy(),
                                  np.asarray(jg.node_graph_id)[:nn])
    assert (jg.edge_weight is None) == (tg.edge_weight is None)
    if tg.edge_weight is not None:
        want = np.asarray(jg.edge_weight)[:ne]
        if weights_tol is None:
            np.testing.assert_array_equal(tg.edge_weight.numpy(), want)
        else:
            np.testing.assert_allclose(tg.edge_weight.numpy(), want,
                                       **weights_tol)
    for what, n in (("nodes", nn), ("edges", ne), ("globals_", ng)):
        jf, tf = getattr(jg, what), getattr(tg, what)
        assert set(jf) == set(tf), what
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(),
                                          np.asarray(jf[k])[:n],
                                          err_msg=f"{what}[{k}]")


def route_parity(jfn, tfn, jg, tg, inputs, *, seed=0, kernel_patches=(),
                 monkeypatch=None, models=None):
    """Hold ``tfn(tg, *args)`` to ``jfn(jg, *args)`` in float64 at F64_TOL:
    the output and the gradient of ``sum(out * cot)`` with respect to every
    input, on the port's rows.

    ``inputs``: ``(kind, array)`` pairs, ``kind`` "node" (the JAX side
    padded to ``jg.n_pad`` rows), "edge" (to ``jg.e_pad``) or "dense" (as
    it is), with "-const" for an input whose gradient is not compared
    (a dropout mask). The output's leading axis holds the port's rows; JAX's is cut
    to them. The JAX side runs under one ``jax.jit`` with the graph an
    argument, so graphs padded alike compile once. ``models``: ``(jax
    model, port module)`` whose parameters are the functions' first
    argument (``jfn(m, jg, *args)``, ``tfn(m, tg, *args)``); their
    gradients are compared too. With ``kernel_patches`` (modules) and
    ``monkeypatch`` the port runs again with each module's
    ``_kernel_route`` patched to True: the card's autograd functions and
    CSR views on CPU tensors, whose kernels take their plain versions,
    held to the same JAX numbers."""
    pads = {"node": jg.n_pad, "edge": jg.e_pad}
    arrays = [np.asarray(a, np.float64) for _, a in inputs]
    kinds = [k.split("-")[0] for k, _ in inputs]
    grads = [not k.endswith("-const") for k, _ in inputs]

    def port_run():
        ts = [t(a, grad=gr) for a, gr in zip(arrays, grads)]
        if models is None:
            return tfn(tg, *ts), ts
        models[1].zero_grad(set_to_none=True)
        return tfn(models[1], tg, *ts), ts

    out, _ = port_run()
    rows = out.shape[0]
    cot = np.random.default_rng(seed).standard_normal(tuple(out.shape))

    jargs = [jnp.asarray(pad_rows(a, pads[k]) if k in pads else a)
             for k, a in zip(kinds, arrays)]
    if models is not None:
        gd, params, rest = nnx.split(models[0], nnx.Param, ...)

        def loss(p, g, *a):
            y = jfn(nnx.merge(gd, p, rest), g, *a)[:rows]
            return jnp.sum(y * cot), y
        first = (params,)
    else:
        def loss(g, *a):
            y = jfn(g, *a)[:rows]
            return jnp.sum(y * cot), y
        first = ()
    n_first = len(first)
    argnums = tuple(i for i in range(n_first + 1 + len(jargs))
                    if i != n_first)
    (_, jy), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(*first, jg, *jargs)

    def check(route):
        y, ts = port_run()
        (y * t(cot)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   err_msg=f"{route}: output", **F64_TOL)
        for i, (tt, jgr) in enumerate(zip(ts, jgrads[n_first:])):
            if not grads[i]:
                continue
            want = np.asarray(jgr)[:tt.shape[0]]
            got = (np.zeros_like(want) if tt.grad is None
                   else tt.grad.numpy())
            np.testing.assert_allclose(got, want, err_msg=f"{route}: d{i}",
                                       **F64_TOL)
        if models is not None:
            assert_grads_match(models[1], jax.tree.map(
                np.asarray, nnx.to_pure_dict(jgrads[0])), **F64_TOL)

    check("plain")
    if kernel_patches:
        for module in kernel_patches:
            monkeypatch.setattr(module, "_kernel_route", lambda _: True)
        check("kernels")
