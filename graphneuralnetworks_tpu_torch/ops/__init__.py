"""Message-passing operations: segment reductions, propagate, attention,
graph-wise ops, kernels."""

from .segment import (AGGREGATIONS, gather, segment_max, segment_mean,
                      segment_min, segment_prod, segment_reduce,
                      segment_softmax, segment_sum)
from .msgpass import (aggregate_neighbors, apply_edges, copy_xi, copy_xj,
                      e_mul_xj, propagate, to_src_space, w_mul_xj,
                      xi_dot_xj, xi_sub_xj, xj_sub_xi)
from .attention import (attention_aggregate, dot_attention,
                        dot_attention_logits, gat_attention, gatv2_attention)
from .gutils import (broadcast_edges, broadcast_nodes, edge_graph_id,
                     reduce_edges, reduce_nodes, softmax_edge_neighbors,
                     softmax_edges, softmax_nodes)

__all__ = ["AGGREGATIONS", "gather", "segment_max", "segment_mean",
           "segment_min", "segment_prod", "segment_reduce", "segment_softmax",
           "segment_sum", "aggregate_neighbors", "apply_edges", "copy_xi",
           "copy_xj", "e_mul_xj", "propagate", "to_src_space",
           "w_mul_xj", "xi_dot_xj",
           "xi_sub_xj", "xj_sub_xi", "attention_aggregate", "dot_attention",
           "dot_attention_logits", "gat_attention", "gatv2_attention",
           "broadcast_edges", "broadcast_nodes", "edge_graph_id",
           "reduce_edges", "reduce_nodes", "softmax_edge_neighbors",
           "softmax_edges", "softmax_nodes"]
