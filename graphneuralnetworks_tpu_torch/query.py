"""Graph queries: node degree.

Counterpart of ``graphneuralnetworks_tpu/query.py:degree``. An unweighted
degree is a difference of CSR offsets; a weighted one is a segment sum of
the weights, through which gradients reach the weights.
"""

from __future__ import annotations

import torch

from .graph import GraphTuple
from .ops.segment import segment_sum

__all__ = ["degree"]


def degree(g: GraphTuple, *, dir: str = "out", edge_weight=None,
           dtype=torch.float32) -> torch.Tensor:
    """Weighted or unweighted degree, ``[num_nodes]``.

    ``edge_weight=None`` uses ``g.edge_weight`` if present, ``False`` forces
    unweighted, and a tensor gives the weights. ``dir`` is "out", "in" or
    "both".
    """
    if dir not in ("out", "in", "both"):
        raise ValueError(f"dir must be out/in/both, got {dir!r}")
    if edge_weight is None:
        ew = g.edge_weight
    elif edge_weight is False:
        ew = None
    else:
        ew = edge_weight
    out = 0
    for side, indptr, idx in (("out", g.indptr_s, g.senders),
                              ("in", g.indptr_r, g.receivers)):
        if dir in (side, "both"):
            if ew is None:
                out = out + torch.diff(indptr).to(dtype)
            else:
                out = out + segment_sum(ew.to(dtype), idx, g.num_nodes)
    return out
