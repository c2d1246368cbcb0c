"""graphneuralnetworks_tpu_torch: the PyTorch/CUDA port of graphneuralnetworks_tpu.

The same graph containers, message passing and layers, held against the JAX
package by the tests, with the TPU's Pallas kernels rewritten by hand in
CUDA for Hopper (``csrc/``). Tensors keep their true sizes: ``[num_nodes,
D]`` node rows and ``[num_edges]`` edges, with no padding.

Every entry point places its tensors on the CUDA card unless the caller
passes ``device="cpu"``; with no card and no explicit device it raises.

Typical use::

    import graphneuralnetworks_tpu_torch as gnn
    from graphneuralnetworks_tpu_torch import models as M
    g = gnn.rand_graph(1000, 5000, seed=0)
    model = M.GNNChain(M.GCNConv(16, 32, torch.relu),
                       M.GATConv(32, 8, heads=4, dropout=0.6))
    y = model(g, torch.randn(1000, 16, device="cuda"), deterministic=False)

Attention aggregation (``gnn.ops.gat_attention``,
``gnn.ops.attention_aggregate``) runs on the edge-softmax kernels of
``ops.cuda.edge_softmax``; message passing on the SpMM kernels of
``ops.cuda.spmm``; max and min aggregation, the graph-wise ops of
``gnn.ops`` (``reduce_nodes``, ``softmax_nodes``, ...) and pooling on the
segment-max kernel of ``ops.cuda.segment``. ``gnn.batch`` joins graphs into
one for graph-level tasks.
"""

import torch


def default_device() -> torch.device:
    """The device entry points use when none is given: the CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


from . import ops  # noqa: E402
from .graph import GraphTuple, graph, from_dense_adjacency  # noqa: E402
from .generate import rand_graph  # noqa: E402
from . import query  # noqa: E402
from .query import *  # noqa: E402,F401,F403
from .utils import edge_decoding, normalize_graphdata  # noqa: E402
from .transform import batch  # noqa: E402
from . import models, training, data, interop, transform  # noqa: E402

__all__ = ["default_device", "resolve_device", "ops", "GraphTuple", "graph",
           "from_dense_adjacency", "rand_graph", "edge_decoding",
           "normalize_graphdata", "batch", "models", "training", "data",
           "interop", "transform", "query"] + query.__all__

__version__ = "0.1.0"
