"""Message-passing operations: segment reductions, propagate, kernels."""

from .segment import (AGGREGATIONS, gather, segment_max, segment_mean,
                      segment_min, segment_prod, segment_reduce, segment_sum)
from .msgpass import (aggregate_neighbors, apply_edges, copy_xi, copy_xj,
                      e_mul_xj, propagate, w_mul_xj, xi_dot_xj, xi_sub_xj,
                      xj_sub_xi)

__all__ = ["AGGREGATIONS", "gather", "segment_max", "segment_mean",
           "segment_min", "segment_prod", "segment_reduce", "segment_sum",
           "aggregate_neighbors", "apply_edges", "copy_xi", "copy_xj",
           "e_mul_xj", "propagate", "w_mul_xj", "xi_dot_xj", "xi_sub_xj",
           "xj_sub_xi"]
