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
one for graph-level tasks, and ``gnn.data.DataLoader`` yields such batches
of a dataset. The host transforms of ``gnn.transform`` (``add_self_loops``,
``remove_edges``, ``negative_sample``, ``rand_edge_split``, ``unbatch``,
...) rebuild a graph on its own device; ``generate``, ``convert``,
``operators`` and ``datastore`` complete the graph toolkit, and
``gnn.data`` reads TUDataset, OGB, METR-LA and TemporalBrains files.

Sampled training on large graphs: ``gnn.NeighborLoader`` (the C++ sampler,
``gnn.native``, built with ``g++`` at first use) yields batches whose
groupings are built on the card (``gnn.device_graph``), and
``sampling.Prefetcher`` samples ahead in threads; ``gnn.DeviceSampler``
samples on the card itself, with ``apply_blocks`` for its per-layer blocks.

Across devices: ``gnn.parallel`` partitions a graph
(``partition_graph``) and runs one process per part over
``torch.distributed``: each part's view (``ShardGraph``) ships the rows its
edges read in one halo exchange, the layers run on it unchanged, and
``make_mesh_train_step`` trains over a (data x graph) ``Mesh``.
``save_checkpoint``/``restore_checkpoint`` keep model and optimizer state;
``profiling`` has ``trace``, ``StepTimer`` and ``benchmark_layers``.

Heterogeneous graphs: ``gnn.heterograph`` builds typed node sets and
relations (each relation's groupings built once, on the card), and
``models.HeteroGraphConv`` runs one layer per relation. Temporal graphs:
``gnn.TemporalGraph`` holds snapshots, and ``models.GNNRecurrence`` runs a
recurrent cell (``TGCNCell``, ``GConvGRUCell``, ...) over ``[T, N, D]``
features on one graph or over the snapshots::

    hg = gnn.heterograph({("user", "rates", "item"): (s, r)},
                         num_nodes={"user": 100, "item": 50}, device="cpu")
    conv = M.HeteroGraphConv({("user", "rates", "item"):
                              M.SAGEConv(16, 8, device="cpu")})
    out = conv(hg, {"user": xu, "item": xi})       # {"item": [50, 8]}
    rnn = M.TGCN(16, 8, device="cpu")
    h = rnn(g, x_seq)                               # [T, N, 8]
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
from .graph import (GraphTuple, graph, device_graph,  # noqa: E402
                    from_dense_adjacency)
from .generate import (rand_graph, knn_graph, radius_graph,  # noqa: E402
                       rand_temporal_radius_graph,
                       rand_temporal_hyperbolic_graph)
from . import query  # noqa: E402
from .query import *  # noqa: E402,F401,F403
from .utils import (edge_encoding, edge_decoding,  # noqa: E402
                    color_refinement, check_num_nodes, check_num_edges,
                    normalize_graphdata)
from . import transform  # noqa: E402
from .transform import *  # noqa: E402,F401,F403
from .datastore import DataStore  # noqa: E402
from .operators import intersect_graphs  # noqa: E402
from .convert import (from_adjacency_list, to_scipy_sparse,  # noqa: E402
                      from_scipy_sparse, to_dense_adjacency)
from . import models, training, data, interop  # noqa: E402
from . import native, sampling, device_sampler  # noqa: E402
from .sampling import (sample_neighbors, induced_subgraph,  # noqa: E402
                       NeighborLoader)
from .device_sampler import DeviceSampler, apply_blocks  # noqa: E402
from .heterograph import (HeteroGraphTuple, Relation,  # noqa: E402
                          add_edges_hetero, add_self_loops_hetero,
                          batch_hetero, heterograph,
                          rand_bipartite_heterograph, rand_heterograph)
from .temporal import TemporalGraph  # noqa: E402
from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa: E402
                         latest_step)
from . import parallel, profiling  # noqa: E402

__all__ = ["default_device", "resolve_device", "ops", "GraphTuple", "graph",
           "device_graph", "from_dense_adjacency", "rand_graph", "knn_graph",
           "radius_graph", "rand_temporal_radius_graph",
           "rand_temporal_hyperbolic_graph", "edge_encoding",
           "edge_decoding", "color_refinement", "check_num_nodes",
           "check_num_edges", "normalize_graphdata", "DataStore",
           "intersect_graphs", "from_adjacency_list", "to_scipy_sparse",
           "from_scipy_sparse", "to_dense_adjacency", "models", "training",
           "data", "interop", "transform", "query", "native", "sampling",
           "device_sampler", "sample_neighbors", "induced_subgraph",
           "NeighborLoader", "DeviceSampler", "apply_blocks",
           "HeteroGraphTuple", "Relation", "heterograph", "rand_heterograph",
           "rand_bipartite_heterograph", "add_self_loops_hetero",
           "add_edges_hetero", "batch_hetero",
           "TemporalGraph", "save_checkpoint", "restore_checkpoint",
           "latest_step", "parallel", "profiling"] + query.__all__ \
    + transform.__all__

__version__ = "0.1.0"
