"""Port's segment ops vs graphneuralnetworks_tpu/ops/segment.py (float64).

Forward and gradient parity for gather and the masked segment reductions,
including empty segments (ids that never occur) and masked-out rows.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu.ops import segment as jseg  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import segment as tseg  # noqa: E402
from torch_parity import F64_TOL, t  # noqa: E402

N_SEG, N_ROWS = 12, 60
OPS = ["sum", "mean", "max", "min", "prod"]


def _inputs(seed, width):
    rng = np.random.default_rng(seed)
    # segments 3 and 7 never occur: empty segments
    ids = rng.choice([i for i in range(N_SEG) if i not in (3, 7)], N_ROWS)
    shape = (N_ROWS,) if width is None else (N_ROWS, width)
    data = rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
    mask = rng.random(N_ROWS) < 0.8
    mask[ids == 5] = False          # segment 5 fully masked
    cot = rng.standard_normal((N_SEG,) + shape[1:])
    return ids, data, mask, cot


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [None, 3])
def test_segment_op_matches_jax(op, masked, width):
    ids, data, mask, cot = _inputs(0, width)
    jfn = getattr(jseg, f"segment_{op}")
    tfn = getattr(tseg, f"segment_{op}")
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.tensor(mask) if masked else None

    def jloss(d):
        out = jfn(d, jnp.asarray(ids), N_SEG, mask=jmask)
        return jnp.sum(out * cot), out

    td = t(data, grad=True)
    tout = tfn(td, torch.tensor(ids), N_SEG, mask=tmask)
    if op == "prod":
        # JAX has no gradient for segment_prod with repeated ids: hold the
        # forward to JAX and the gradient to finite differences
        jout = jfn(jnp.asarray(data), jnp.asarray(ids), N_SEG, mask=jmask)
        assert torch.autograd.gradcheck(
            lambda d: tfn(d, torch.tensor(ids), N_SEG, mask=tmask), (td,))
    else:
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(data))
        (tout * t(cot)).sum().backward()
        np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad),
                                   **F64_TOL)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F64_TOL)


@pytest.mark.parametrize("op", OPS)
def test_segment_reduce_dispatch(op):
    ids, data, _, _ = _inputs(1, 4)
    got = tseg.segment_reduce(op, t(data), torch.tensor(ids), N_SEG)
    want = jseg.segment_reduce(op, jnp.asarray(data), jnp.asarray(ids), N_SEG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


def test_empty_segments_are_zero():
    ids, data, _, _ = _inputs(2, 2)
    for op in ("sum", "mean", "max", "min"):
        out = tseg.segment_reduce(op, t(data), torch.tensor(ids), N_SEG)
        assert torch.all(out[[3, 7]] == 0), op
    with pytest.raises(ValueError):
        tseg.segment_reduce("median", t(data), torch.tensor(ids), N_SEG)


def test_gather_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 4))
    idx = rng.integers(0, 10, 25)
    cot = rng.standard_normal((25, 4))
    jgrad = jax.grad(lambda v: jnp.sum(jseg.gather(v, jnp.asarray(idx))
                                       * cot))(jnp.asarray(x))
    tx = t(x, grad=True)
    out = tseg.gather(tx, torch.tensor(idx))
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), x[idx], **F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **F64_TOL)
