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
