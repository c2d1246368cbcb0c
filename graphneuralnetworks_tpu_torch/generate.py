"""Random and geometric graph generators (host-side numpy).

Counterpart of ``graphneuralnetworks_tpu/generate.py`` (reference GNNGraphs
generate.jl): ``rand_graph``, ``knn_graph``, ``radius_graph`` and the two
temporal generators, with the same numpy calls, so one seed gives the same
graphs in both packages. The graphs are built on ``device`` (``None``: the
CUDA card).
"""

from __future__ import annotations

import numpy as np

from .graph import GraphTuple, graph
from .utils import edge_decoding, normalize_graphdata

__all__ = ["rand_graph", "knn_graph", "radius_graph",
           "rand_temporal_radius_graph", "rand_temporal_hyperbolic_graph"]


def rand_graph(num_nodes: int, num_edges: int, *, bidirected: bool = True,
               seed: int | None = None, nodes=None, edges=None,
               edge_weight=None, rng: np.random.Generator | None = None,
               device=None, **graph_kw) -> GraphTuple:
    """Erdős–Rényi G(n, m) by sampling unique edge ids (GNNGraphs
    generate.jl:41-65).

    ``bidirected=True`` samples ``num_edges / 2`` undirected pairs and
    stores both directions. ``device=None`` places the graph on the CUDA
    card.
    """
    rng = rng or np.random.default_rng(seed)
    n = int(num_nodes)
    if bidirected:
        if num_edges % 2:
            raise ValueError("bidirected rand_graph needs even num_edges")
        m = num_edges // 2
        maxid = n * (n - 1) // 2
    else:
        m = num_edges
        maxid = n * (n - 1)
    if m > maxid:
        raise ValueError("too many edges requested")
    ids = rng.choice(maxid, size=m, replace=False)
    s, r = edge_decoding(ids, n, directed=not bidirected, self_loops=False)
    if bidirected:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
        # features given once per undirected pair serve both directions
        edges = normalize_graphdata(edges, default_name="e", n=len(s),
                                    duplicate_if_needed=True) or None
        if edge_weight is not None and len(np.asarray(edge_weight)) == m:
            edge_weight = np.concatenate([edge_weight, edge_weight])
    return graph(s, r, num_nodes=n, nodes=nodes, edges=edges,
                 edge_weight=edge_weight, device=device, **graph_kw)


def _sq_dists(p: np.ndarray) -> np.ndarray:
    """Squared distances between the rows of ``p``, as the JAX package
    computes them."""
    pp = (p * p).sum(-1)
    return np.maximum(pp[:, None] + pp[None, :] - 2.0 * (p @ p.T), 0.0)


def _points(points, graph_indicator):
    pts = np.asarray(points.cpu() if hasattr(points, "cpu") else points,
                     dtype=np.float64)
    n = pts.shape[0]
    gi = (np.zeros(n, np.int64) if graph_indicator is None
          else np.asarray(graph_indicator, np.int64))
    return pts, n, gi


def knn_graph(points, k: int, *, graph_indicator=None,
              self_loops: bool = False, dir: str = "in", nodes=None,
              **kw) -> GraphTuple:
    """k-nearest-neighbour graph of ``points [N, D]`` (generate.jl:112-145):
    each node linked to its ``k`` nearest, within its graph when
    ``graph_indicator`` is given; ``dir="in"`` points the edges from the
    neighbour to the node."""
    pts, n, gi = _points(points, graph_indicator)
    D = _sq_dists(pts)
    D[gi[:, None] != gi[None, :]] = np.inf
    if not self_loops:
        np.fill_diagonal(D, np.inf)
    nbr = np.argsort(D, axis=1)[:, :k]
    tgt = np.repeat(np.arange(n), k)
    src = nbr.reshape(-1)
    valid = ~np.isinf(D[tgt, src])
    src, tgt = src[valid], tgt[valid]
    s, r = (src, tgt) if dir == "in" else (tgt, src)
    return graph(s, r, num_nodes=n, nodes=nodes, node_graph_id=gi,
                 num_graphs=int(gi.max()) + 1, **kw)


def radius_graph(points, radius: float, *, graph_indicator=None,
                 self_loops: bool = False, dir: str = "in", nodes=None,
                 **kw) -> GraphTuple:
    """Every pair of ``points`` within ``radius``, within its graph
    (generate.jl:196-222)."""
    pts, n, gi = _points(points, graph_indicator)
    mask = _sq_dists(pts) <= radius * radius
    mask &= gi[:, None] == gi[None, :]
    if not self_loops:
        np.fill_diagonal(mask, False)
    src, tgt = np.nonzero(mask)
    s, r = (src, tgt) if dir == "in" else (tgt, src)
    return graph(s, r, num_nodes=n, nodes=nodes, node_graph_id=gi,
                 num_graphs=int(gi.max()) + 1, **kw)


def rand_temporal_radius_graph(number_nodes: int, number_snapshots: int,
                               speed: float, radius: float, *,
                               self_loops: bool = False,
                               rng: np.random.Generator | None = None,
                               device=None):
    """Points walking at random in the unit square, a radius graph of each
    step (generate.jl:265-284): a :class:`~.temporal.TemporalGraph`."""
    from .temporal import TemporalGraph
    rng = rng or np.random.default_rng()
    pos = rng.random((number_nodes, 2))
    snaps = []
    for _ in range(number_snapshots):
        snaps.append(radius_graph(pos, radius, self_loops=self_loops,
                                  device=device))
        pos = np.clip(pos + speed * rng.standard_normal(pos.shape), 0, 1)
    return TemporalGraph.from_snapshots(snaps)


def rand_temporal_hyperbolic_graph(number_nodes: int, number_snapshots: int,
                                   *, alpha: float, R: float, speed: float,
                                   zeta: float = 1.0,
                                   self_loops: bool = False,
                                   rng: np.random.Generator | None = None,
                                   device=None):
    """Points moving on the hyperbolic plane, linked within hyperbolic
    distance ``R`` at each step (generate.jl:340-380): a
    :class:`~.temporal.TemporalGraph`."""
    from .temporal import TemporalGraph
    rng = rng or np.random.default_rng()
    # radial density alpha sinh(alpha r) / (cosh(alpha R) - 1), by its
    # inverse cdf
    u = rng.random(number_nodes)
    rr = np.arccosh(1 + u * (np.cosh(alpha * R) - 1)) / alpha
    theta = rng.random(number_nodes) * 2 * np.pi
    snaps = []
    for _ in range(number_snapshots):
        dt = np.abs(theta[:, None] - theta[None, :])
        dt = np.pi - np.abs(np.pi - dt)
        ch = (np.cosh(zeta * rr)[:, None] * np.cosh(zeta * rr)[None, :]
              - np.sinh(zeta * rr)[:, None] * np.sinh(zeta * rr)[None, :]
              * np.cos(dt))
        d = np.arccosh(np.maximum(ch, 1.0)) / zeta
        mask = d <= R
        if not self_loops:
            np.fill_diagonal(mask, False)
        s, t = np.nonzero(mask)
        snaps.append(graph(s, t, num_nodes=number_nodes, device=device))
        theta = (theta + speed * rng.standard_normal(number_nodes)) \
            % (2 * np.pi)
        rr = np.clip(rr + speed * rng.standard_normal(number_nodes), 0, R)
    return TemporalGraph.from_snapshots(snaps)
