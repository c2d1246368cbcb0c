"""The port's runtime (``checkpoint.py``, ``profiling.py``) against the JAX
package's.

- Checkpoints: the same layout as JAX's (``step_<N:010d>``, ``latest.json``
  holding ``{"step": N}``); a model's and its Adam optimizer's state saved
  at step 2 and restored into fresh ones (in float64 and float32) resume
  training bit for bit; tensors restore on the target's device and dtype.
- ``StepTimer``: on the same step times as JAX's, the same ``mean_s``
  (the first step dropped), ``edges_per_s`` and ``report()`` string.
- ``trace`` writes a non-empty Chrome trace; ``benchmark_layers`` gives
  JAX's row keys.
"""

import json
import os

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphneuralnetworks_tpu import checkpoint as JC  # noqa: E402
from graphneuralnetworks_tpu import profiling as JPR  # noqa: E402
import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402
from graphneuralnetworks_tpu_torch import checkpoint as TC  # noqa: E402
from graphneuralnetworks_tpu_torch import models as TM  # noqa: E402
from graphneuralnetworks_tpu_torch import profiling as TPR  # noqa: E402
from graphneuralnetworks_tpu_torch.training import (  # noqa: E402
    make_train_step, masked_cross_entropy)


def _setup(dtype, seed=0):
    g = tgnn.rand_graph(40, 160, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model = TM.GNNChain(
        TM.GCNConv(5, 8, torch.relu, generator=gen, device="cpu",
                   dtype=dtype),
        TM.GATConv(8, 3, heads=2, concat=False, generator=gen, device="cpu",
                   dtype=dtype))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((40, 5)), dtype=dtype)
    y = torch.as_tensor(rng.integers(0, 3, 40))
    mask = torch.ones(40, dtype=torch.bool)

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    return model, opt, make_train_step(model, opt, loss_fn), (g, x, y, mask)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_resume_is_bit_for_bit(tmp_path, dtype):
    model, opt, step, batch = _setup(dtype)
    losses = [float(step(*batch)) for _ in range(2)]
    path = TC.save_checkpoint(str(tmp_path), 2, {"model": model,
                                                 "opt": opt})
    assert path == os.path.join(str(tmp_path), "step_0000000002")
    assert os.path.isfile(os.path.join(path, "state.pt"))
    after = [float(step(*batch)) for _ in range(3)]

    model2, opt2, step2, _ = _setup(dtype, seed=5)   # other weights
    assert TC.latest_step(str(tmp_path)) == 2
    target = {"model": model2, "opt": opt2}
    assert TC.restore_checkpoint(str(tmp_path), target) is not None
    resumed = [float(step2(*batch)) for _ in range(3)]
    assert resumed == after and losses[1] != after[0]
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), k


def test_layout_matches_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpath = JC.save_checkpoint(jdir, 7, {"w": jnp.ones(3)})
    tpath = TC.save_checkpoint(tdir, 7, {"w": torch.ones(3)})
    assert os.path.basename(jpath) == os.path.basename(tpath)
    for d in (jdir, tdir):
        with open(os.path.join(d, "latest.json")) as f:
            assert json.load(f) == {"step": 7}
    assert JC.latest_step(jdir) == TC.latest_step(tdir) == 7
    assert TC.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "none"), {"w": torch.ones(3)})


def test_tensors_restore_on_the_target(tmp_path):
    d = str(tmp_path)
    TC.save_checkpoint(d, 1, {"w": torch.arange(4.0), "n": 3})
    TC.save_checkpoint(d, 2, {"w": torch.arange(4.0) * 2, "n": 4})
    got = TC.restore_checkpoint(d, {"w": torch.zeros(4, dtype=torch.float64),
                                    "n": 0}, step=1)
    assert got["n"] == 3 and got["w"].dtype == torch.float64
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4.0))
    assert TC.restore_checkpoint(d, {"w": torch.zeros(4), "n": 0})["n"] == 4


@pytest.mark.parametrize("times,edges", [
    ([0.5, 0.25, 0.125, 0.375], 1000), ([0.2], None), ([0.3, 0.1], 7)])
def test_step_timer_matches_jax(monkeypatch, times, edges):
    clock = iter(np.cumsum([0.0] + [v for t in times for v in (0.0, t)])
                 .tolist()[1:])
    monkeypatch.setattr(TPR.time, "perf_counter", lambda: next(clock))
    timer = TPR.StepTimer(edges, device="cpu")
    for _ in times:
        with timer:
            pass
    ref = JPR.StepTimer(edges)
    ref.history = list(timer.history)
    np.testing.assert_allclose(timer.history, times, rtol=1e-12)
    assert timer.mean_s == ref.mean_s
    assert timer.edges_per_s == ref.edges_per_s
    assert timer.report() == ref.report()
    assert set(json.loads(timer.report())) == (
        {"steps", "mean_ms"} | ({"edges_per_s"} if edges else set()))


def test_step_timer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPR.StepTimer(10)


def test_trace_writes_a_chrome_trace(tmp_path):
    g = tgnn.rand_graph(30, 90, seed=0, device="cpu")
    layer = TM.GCNConv(4, 4, device="cpu")
    with TPR.trace(str(tmp_path / "tr")) as prof:
        layer(g, torch.randn(30, 4)).sum().backward()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_benchmark_layers_rows():
    rows = TPR.benchmark_layers(
        {"gcn": lambda a, b: TM.GCNConv(a, b, device="cpu"),
         "sage": lambda a, b: TM.SAGEConv(a, b, device="cpu")},
        graph_sizes=(10, 40), d=8, iters=2, device="cpu")
    assert [(r["layer"], r["n"]) for r in rows] == [
        ("gcn", 10), ("gcn", 40), ("sage", 10), ("sage", 40)]
    for r in rows:
        assert set(r) == {"layer", "n", "forward_ms", "grad_ms"}
        assert r["forward_ms"] >= 0 and r["grad_ms"] >= 0
