"""The SpMM kernels' wrappers and plain versions (no JAX needed).

- The plain versions (the CPU path, and the reference the CUDA kernels are
  held to) against a dense adjacency product in float64.
- The wrappers' input checks, and the dispatch rule: CPU tensors take the
  plain version, CUDA tensors the kernel, anything else raises.
- ``gpu``-marked: the CUDA kernels against the plain versions on the card.
  This file imports no JAX, so on a machine with a card and no JAX it runs
  without the suite's conftest:

      python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -m gpu
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S  # noqa: E402


def _graph(seed, device, dtype=torch.float64):
    """Directed multigraph on 50 nodes, the last 10 isolated, weighted."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, 40, 160), rng.integers(0, 40, 160)
    w = torch.tensor(rng.random(160) + 0.5, dtype=dtype)
    return tgnn.graph(s, r, num_nodes=50, edge_weight=w, device=device)


def test_plain_versions_match_dense():
    g = _graph(4, "cpu")
    n = g.num_nodes
    rng = np.random.default_rng(2)
    x, dy = rng.standard_normal((n, 6)), rng.standard_normal((n, 6))
    ws, ss, rs = g.edge_weight.numpy(), g.senders.numpy(), g.receivers.numpy()
    A = np.zeros((n, n))
    np.add.at(A, (rs, ss), ws)
    tol = dict(rtol=1e-12, atol=1e-12)
    y = S.spmm_plain(g.indptr_r, g.col_r, None, g.edge_weight,
                     torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), A @ x, **tol)
    dx = S.spmm_plain(g.indptr_s, g.col_s, g.eid_s, g.edge_weight,
                      torch.tensor(dy))
    np.testing.assert_allclose(dx.numpy(), A.T @ dy, **tol)
    dx2, dw = S.spmm_sddmm_plain(g.indptr_s, g.col_s, g.eid_s,
                                 g.edge_weight, torch.tensor(dy),
                                 torch.tensor(x))
    np.testing.assert_allclose(dx2.numpy(), A.T @ dy, **tol)
    np.testing.assert_allclose(dw.numpy(), np.sum(dy[rs] * x[ss], -1), **tol)
    # col=None reads rows in grouping order: the gather backward
    e = rng.standard_normal((g.num_edges, 3))
    want = np.zeros((n, 3))
    np.add.at(want, rs, e)
    got = S.spmm_plain(g.indptr_r, None, None, None, torch.tensor(e))
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_kernel_wrappers_validate_inputs():
    g = tgnn.rand_graph(16, 40, seed=0, device="cpu")
    x = torch.randn(16, 4)
    with pytest.raises(TypeError):
        S._check_launch(g.indptr_r, g.col_r, None, None, x.double())
    with pytest.raises(TypeError):
        S._check_launch(g.indptr_r, g.col_r.long(), None, None, x)
    with pytest.raises(ValueError):
        S._check_launch(g.indptr_r, g.col_r, None, None, x.t())
    S._check_launch(g.indptr_r, g.col_r, g.eid_s, torch.ones(40), x)
    # a tensor neither on the CPU nor on a CUDA card has no route
    with pytest.raises(ValueError):
        S.spmm_csr(g.indptr_r, g.col_r, None, None,
                   torch.empty(16, 4, device="meta"))


def test_cpu_tensors_launch_nothing():
    g = _graph(5, "cpu", torch.float32)
    x = torch.randn(g.num_nodes, 8, requires_grad=True)
    w = g.edge_weight.clone().requires_grad_()
    before = dict(S.launches)
    y = tgnn.ops.propagate(tgnn.ops.e_mul_xj, g, "sum", xj=x, e=w)
    y.sum().backward()
    assert S.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 8, 64, 128, 200])
def test_kernels_match_plain_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = _graph(6, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(g.num_nodes, d, device="cuda", generator=gen)
    dy = torch.randn(g.num_nodes, d, device="cuda", generator=gen)
    e = torch.randn(g.num_edges, d, device="cuda", generator=gen)
    before = dict(S.launches)
    for args in ((g.indptr_r, g.col_r, None, None, x),
                 (g.indptr_r, g.col_r, None, g.edge_weight, x),
                 (g.indptr_s, g.col_s, g.eid_s, g.edge_weight, dy),
                 (g.indptr_r, None, None, None, e)):
        torch.testing.assert_close(S.spmm_csr(*args), S.spmm_plain(*args),
                                   rtol=1e-5, atol=1e-5)
    args = (g.indptr_s, g.col_s, g.eid_s, g.edge_weight, dy, x)
    for a, b in zip(S.spmm_sddmm(*args), S.spmm_sddmm_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert S.launches["k1"] == before["k1"] + 4
    assert S.launches["k2"] == before["k2"] + 1
