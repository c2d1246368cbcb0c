"""Multi-device execution: graph partitioning and halo-exchange message
passing over ``torch.distributed``, one process per part.

Counterpart of ``graphneuralnetworks_tpu/parallel``. The JAX package's
``union_capacities``, ``shard_partitioned`` and ``stack_partitions`` exist
to give ``shard_map`` one padded, stacked shape; here each part keeps its
true size in its own process, and ``make_mesh_train_step`` takes one
``PartitionedGraph`` per data replica, as a list.
"""

from .mesh import Mesh
from .partition import PartitionedGraph, partition_graph, partition_nodes
from .shard import (all_reduce_grads, halo_propagate_local,
                    make_mesh_train_step, make_sharded_apply,
                    make_sharded_propagate)
from .shardgraph import ShardGraph, shard_graph_local

__all__ = ["Mesh", "PartitionedGraph", "partition_graph", "partition_nodes",
           "halo_propagate_local", "make_sharded_propagate",
           "make_sharded_apply", "make_mesh_train_step", "all_reduce_grads",
           "ShardGraph", "shard_graph_local"]
