"""The port's ``ops.runs`` against the JAX package's, on
``tests/test_runs.py``'s cases: ``run_gather(src, build_run_meta(p, ...))``
is ``src[p]`` with 0 at the dummy index, in both modes, for scalar and row
sources and ragged lengths; both packages return None for the same plans
(more than ``k_cap`` pieces in a chunk, or no indices) and count the same
pieces. The port's gather is a plain index, so the values agree exactly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu.ops import runs as JR  # noqa: E402
from graphneuralnetworks_tpu_torch.ops import runs as TR  # noqa: E402
from test_runs import _piecewise_perm  # noqa: E402


def _both(p, src, **kw):
    jm = JR.build_run_meta(p, **kw)
    tm = TR.build_run_meta(p, device="cpu", **kw)
    assert (jm is None) == (tm is None)
    if jm is None:
        return None
    assert (tm.k, tm.ch, tm.const, tm.out_len) == (jm.k, jm.ch, jm.const,
                                                    jm.out_len)
    got = TR.run_gather(torch.as_tensor(src), tm).numpy()
    want = np.asarray(JR.run_gather(jnp.asarray(src), jm))
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("ch", [8, 32, 128])
def test_run_mode_matches_jax(ch):
    rng = np.random.default_rng(0)
    m, src_len = 1000, 1700
    p = _piecewise_perm(rng, m, src_len)
    for src in (rng.standard_normal(src_len),
                rng.standard_normal((src_len, 7))):
        got = _both(p, src, ch=ch, dummy_idx=src_len)
        ref = np.where((p == src_len).reshape((-1,) + (1,) * (src.ndim - 1)),
                       0.0, src[np.minimum(p, src_len - 1)])
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ch", [8, 32, 128])
def test_const_mode_matches_jax(ch):
    rng = np.random.default_rng(1)
    recv = np.sort(rng.integers(0, 50, size=1000))
    src = rng.standard_normal((50, 5))
    np.testing.assert_array_equal(_both(recv, src, ch=ch, const=True),
                                  src[recv])
    np.testing.assert_array_equal(_both(recv, src[:, 0], ch=ch, const=True),
                                  src[recv, 0])


def test_const_mode_with_dummies_matches_jax():
    rng = np.random.default_rng(2)
    recv = np.sort(rng.integers(0, 20, size=256)).astype(np.int64)
    recv[200:] = 20
    src = rng.standard_normal((20, 3))
    out = _both(recv, src, ch=64, const=True, dummy_idx=20)
    np.testing.assert_array_equal(out[:200], src[recv[:200]])
    assert not out[200:].any()


def test_k_cap_fallback_ragged_and_empty_match_jax():
    rng = np.random.default_rng(3)
    assert _both(rng.integers(0, 1700, size=1000), np.zeros(1700), ch=128,
                 k_cap=8) is None
    p = _piecewise_perm(rng, 37, 500)
    src = rng.standard_normal(500)
    out = _both(p, src, ch=16, dummy_idx=500)
    assert out.shape == (37,)
    assert _both(np.zeros(0, np.int64), src, ch=8) is None


def test_build_run_meta_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.build_run_meta(np.arange(10), ch=8)
