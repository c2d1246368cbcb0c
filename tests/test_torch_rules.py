"""Rules of the port: it imports no JAX, and it runs on the card by default.

- In a fresh interpreter whose import system refuses ``jax``, ``flax``,
  ``optax`` and ``graphneuralnetworks_tpu`` (whole module names: the port's
  own name starts with the last one), the port imports and runs a forward
  and backward pass on the CPU.
- Neither ``chip_smoke.py`` nor any module of the port names one of them in
  an import statement.
- Entry points given no device place tensors on the CUDA card, and raise
  when there is none.
"""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphneuralnetworks_tpu_torch as tgnn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "graphneuralnetworks_tpu_torch")
BLOCKED = ("jax", "flax", "optax", "graphneuralnetworks_tpu")

_CHILD = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}

def blocked(name):
    return name.split(".")[0] in BLOCKED

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import: {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
import graphneuralnetworks_tpu_torch as gnn
from graphneuralnetworks_tpu_torch import models as M
g = gnn.rand_graph(20, 60, seed=0, device="cpu")
model = M.GNNChain(M.GCNConv(3, 4, torch.relu, device="cpu"),
                   M.GATConv(4, 2, heads=2, dropout=0.5, device="cpu"),
                   M.GATv2Conv(4, 2, heads=2, dropout=0.5, device="cpu"),
                   M.TransformerConv(4, 2, heads=2, batch_norm=True,
                                     device="cpu"),
                   M.AGNNConv(device="cpu"),
                   M.SAGEConv(4, 2, device="cpu"))
y = model(g, torch.randn(20, 3), deterministic=False)
(y.sum() + M.DotDecoder()(g, y).sum()).backward()
assert y.shape == (20, 2)
graphs, _ = gnn.data.synthetic_tudataset(4, device="cpu")
gb = gnn.batch(graphs, device="cpu")
pools = M.GNNChain(M.EdgeConv(M.MLP([14, 6], device="cpu")),
                   M.GraphConv(6, 6, aggr="max", device="cpu"))
h = pools(gb, gb.x)
u = (M.GlobalPool("max")(gb, h).sum() + M.Set2Set(6, 2, device="cpu")(gb, h).sum()
     + M.GlobalAttentionPool(torch.nn.Linear(6, 1))(gb, h).sum()
     + M.TopKPool(6, 3, device="cpu")(gb, h)[0].sum()
     + gnn.ops.softmax_edge_neighbors(gb, h[gb.senders]).sum())
u.backward()
bad = sorted(m for m in sys.modules if blocked(m))
assert not bad, bad
print("OK")
"""


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c",
                          _CHILD.format(blocked=BLOCKED)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _python_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for d, _, files in os.walk(PKG):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_python_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statements(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"


def test_blocked_names_are_whole_module_names():
    assert "graphneuralnetworks_tpu_torch".split(".")[0] not in BLOCKED


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.graph([0, 1], [1, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.rand_graph(10, 20, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.data.synthetic_cora(num_nodes=50, num_features=14)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.GATConv(3, 4, heads=2, dropout=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.GATv2Conv(3, 4, heads=2, dropout=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.TransformerConv(3, 4, heads=2, batch_norm=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.AGNNConv()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.data.synthetic_tudataset(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.Set2Set(3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.models.TopKPool(3, 2)
    graphs, _ = tgnn.data.synthetic_tudataset(2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.batch(graphs)
    g = tgnn.graph(np.array([0, 1]), np.array([1, 0]), device="cpu")
    assert g.device.type == "cpu" and g.indptr_r.device.type == "cpu"
