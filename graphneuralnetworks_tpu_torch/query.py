"""Graph queries: degree, adjacency, Laplacians, neighbourhood structure.

Counterpart of ``graphneuralnetworks_tpu/query.py`` (reference
GNNGraphs/src/query.jl). The JAX package returns ``[N_pad, N_pad]``
matrices and ``[G_pad]`` vectors; here they are ``[num_nodes, num_nodes]``
and ``[num_graphs]``. Gradients reach edge weights through ``degree`` and
``adjacency_matrix`` and never the index structure, as there.

An unweighted degree is a difference of CSR offsets, clamped where a sum
of ones in the requested dtype stops growing; a weighted one is a segment
sum of the weights in that dtype. The dense queries (adjacency, Laplacians,
``khop_adj``) are for small graphs: they refuse the graph sizes the JAX
package refuses (:func:`_check_dense`). ``degree`` and
``adjacency_matrix`` (and the queries on them) count only the valid edges
of a graph with ``edge_valid``, as JAX's do through ``edge_mask``; the
structural queries on the edge list raise on one. The power iterations
behind ``laplacian_lambda_max`` and ``scaled_laplacian`` start from a
vector drawn by a ``torch.Generator`` seeded 20240607 on the CPU in
float64 (:func:`start_vector`): the same vector on every device, but not
the bits of JAX's ``jax.random.key(20240607)`` draw, so the two packages
agree on ``λ_max`` to the iteration's convergence, not to rounding.
"""

from __future__ import annotations

import torch

from .graph import GraphTuple, no_edge_valid
from .ops.segment import count_as, gather, segment_sum

__all__ = ["degree", "adjacency_matrix", "laplacian_matrix",
           "normalized_adjacency", "normalized_laplacian",
           "scaled_laplacian", "laplacian_lambda_max", "graph_indicator",
           "has_self_loops", "has_multi_edges", "is_bidirected", "has_edge",
           "has_isolated_nodes", "is_directed", "get_graph_type", "khop_adj",
           "node_features", "edge_features", "graph_features",
           "adjacency_list", "inneighbors", "outneighbors"]

# the JAX package's dense-size limit, on its padded node count
# (query.py:99-110): floor(sqrt(2^31 - 1))
_DENSE_MAX_N_PAD = 46341
# the seed of the JAX package's power-iteration start vectors
_START_SEED = 20240607


def degree(g: GraphTuple, *, dir: str = "out", edge_weight=None,
           dtype=torch.float32) -> torch.Tensor:
    """Weighted or unweighted degree, ``[num_nodes]``.

    Counted in ``dtype``, as the JAX package's sum of ones (or weights) in
    ``dtype`` counts: an unweighted bfloat16 degree stops at 256
    (:func:`~.ops.segment.count_as`).
    ``edge_weight=None`` uses ``g.edge_weight`` if present, ``False`` forces
    unweighted, and a tensor gives the weights. ``dir`` is "out", "in" or
    "both".

    On a part's view across devices (``parallel.ShardGraph``), whose
    senders index the halo buffer, the out-degree of the owned nodes is
    their in-degree over the reversed partition's view (``g.reverse()``,
    local like every receiver-keyed count), weighted by that view's own
    weights; explicit weights raise there, since its edges are in another
    order.
    """
    if dir not in ("out", "in", "both"):
        raise ValueError(f"dir must be out/in/both, got {dir!r}")
    if edge_weight is None:
        ew = g.edge_weight
    elif edge_weight is False:
        ew = None
    else:
        ew = edge_weight
    if g.edge_valid is not None:
        ew = (g.edge_valid.to(dtype) if ew is None
              else torch.where(g.edge_valid, ew, torch.zeros_like(ew)))
    out = 0
    if dir in ("out", "both") and hasattr(g, "src_space"):
        if edge_weight is not None and edge_weight is not False:
            raise ValueError(
                "out-degree on a part's view across devices cannot take "
                "explicit edge weights (the reversed partition's edges are "
                "in another order); use the graph's own edge_weight")
        gr = g.reverse()
        out = degree(gr, dir="in", dtype=dtype,
                     edge_weight=None if ew is not None else False)
        if dir == "out":
            return out
        dir = "in"
    for side, indptr, idx in (("out", g.indptr_s, g.senders),
                              ("in", g.indptr_r, g.receivers)):
        if dir in (side, "both"):
            if ew is None:
                out = out + count_as(torch.diff(indptr), dtype)
            else:
                out = out + segment_sum(ew.to(dtype), idx, g.num_nodes)
    return out


def jax_n_pad(num_nodes: int) -> int:
    """The JAX package's default padded node count for ``num_nodes`` nodes,
    ``round_up(N + 1, 8)`` (``graph.py:pad_sizes``): the size its
    size-dependent choices test."""
    return -(-(num_nodes + 1) // 8) * 8


def _check_dense(g: GraphTuple, what: str) -> None:
    """Refuse a dense ``[N, N]`` query where the JAX package does: its padded
    node count over ``_DENSE_MAX_N_PAD``, a dense matrix of more than 8
    GB."""
    n_pad = jax_n_pad(g.num_nodes)
    if n_pad > _DENSE_MAX_N_PAD:
        raise ValueError(f"{what}: {g.num_nodes} nodes (padded {n_pad} > "
                         f"{_DENSE_MAX_N_PAD}) make a dense matrix of more "
                         "than 8 GB; dense queries are for small graphs")


def _eye(g: GraphTuple, dtype) -> torch.Tensor:
    return torch.eye(g.num_nodes, dtype=dtype, device=g.device)


def adjacency_matrix(g: GraphTuple, *, dtype=torch.float32,
                     weighted: bool = True) -> torch.Tensor:
    """Dense ``[N, N]`` adjacency, ``A[s, r]`` the sum of the weights of the
    edges ``s -> r`` (or their multiplicity), differentiable in the
    weights."""
    _check_dense(g, "adjacency_matrix")
    n = g.num_nodes
    w = (g.edge_weight.to(dtype) if weighted and g.edge_weight is not None
         else torch.ones(g.num_edges, dtype=dtype, device=g.device))
    if g.edge_valid is not None:
        w = torch.where(g.edge_valid, w, torch.zeros_like(w))
    return torch.zeros((n, n), dtype=dtype, device=g.device).index_put(
        (g.senders, g.receivers), w, accumulate=True)


def laplacian_matrix(g: GraphTuple, *, dtype=torch.float32,
                     dir: str = "out") -> torch.Tensor:
    """``L = D - A`` (query.jl:424-428)."""
    A = adjacency_matrix(g, dtype=dtype)
    return torch.diag(degree(g, dir=dir, dtype=dtype)) - A


def normalized_adjacency(g: GraphTuple, *, dtype=torch.float32,
                         add_self_loops: bool = False) -> torch.Tensor:
    """``D^-1/2 (A [+ I]) D^-1/2`` with ``D`` the row sums
    (query.jl:442-454)."""
    A = adjacency_matrix(g, dtype=dtype)
    if add_self_loops:
        A = A + _eye(g, dtype)
    d = A.sum(1)
    inv_sqrt = torch.where(d > 0, torch.rsqrt(d.clamp(min=1e-12)),
                           torch.zeros_like(d))
    return inv_sqrt[:, None] * A * inv_sqrt[None, :]


def normalized_laplacian(g: GraphTuple, *, dtype=torch.float32,
                         add_self_loops: bool = False) -> torch.Tensor:
    """``I - D^-1/2 A D^-1/2`` (query.jl:456-460)."""
    return _eye(g, dtype) - normalized_adjacency(
        g, dtype=dtype, add_self_loops=add_self_loops)


def start_vector(shape, dtype, device) -> torch.Tensor:
    """The power iterations' pseudo-random start: a float64 normal draw of
    a CPU ``torch.Generator`` seeded 20240607, cast to ``dtype`` and moved
    to ``device``, so every device starts from the same vector. (A
    structured start, all ones, is the λ=0 eigenvector of a regular graph's
    normalized Laplacian and would converge to 0.)"""
    gen = torch.Generator().manual_seed(_START_SEED)
    v = torch.randn(shape, generator=gen, dtype=torch.float64)
    return v.to(dtype=dtype, device=device)


def _unit_columns(w: torch.Tensor) -> torch.Tensor:
    return w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp(
        min=1e-12)


def power_eigmax(g: GraphTuple, apply, dtype, iters: int) -> torch.Tensor:
    """Each graph's largest-|λ| eigenvalue of the block-diagonal operator
    ``apply`` (``[N, G] -> [N, G]``), ``[G]``: a power iteration with one
    column per graph, masked to its nodes, all advanced by one ``apply`` a
    step from :func:`start_vector` (the reference uses KrylovKit's
    ``eigmax``, query.jl:474-487 and 598-610)."""
    ids = torch.arange(g.num_graphs, device=g.device)
    sel = (g.node_graph_id[:, None] == ids[None]).to(dtype)
    v = _unit_columns(start_vector(sel.shape, dtype, g.device) * sel)
    for _ in range(iters):
        v = _unit_columns(apply(v) * sel)
    return (v * apply(v)).sum(0)


def _dense_eigmax(g: GraphTuple, L: torch.Tensor, iters: int):
    """:func:`power_eigmax` of the dense ``L``: a scalar for one graph,
    ``[G]`` for a batch."""
    lam = power_eigmax(g, lambda v: L @ v, L.dtype, iters)
    return lam[0] if g.num_graphs == 1 else lam


def laplacian_lambda_max(g: GraphTuple, *, dtype=torch.float32,
                         add_self_loops: bool = False,
                         iters: int = 100) -> torch.Tensor:
    """λ_max of the normalized Laplacian (query.jl:598-610): a scalar for
    one graph, ``[G]`` for a batch."""
    L = normalized_laplacian(g, dtype=dtype, add_self_loops=add_self_loops)
    return _dense_eigmax(g, L, iters)


def scaled_laplacian(g: GraphTuple, *, dtype=torch.float32,
                     iters: int = 100) -> torch.Tensor:
    """``2 L / λ_max - I`` (query.jl:474-487), for Chebyshev layers; in a
    batch each graph's rows are scaled by its own λ_max."""
    L = normalized_laplacian(g, dtype=dtype)
    lam = _dense_eigmax(g, L, iters)
    if g.num_graphs > 1:
        lam = lam[g.node_graph_id][:, None]
    return 2.0 * L / lam.clamp(min=1e-12) - _eye(g, dtype)


def graph_indicator(g: GraphTuple, *, edges: bool = False) -> torch.Tensor:
    """Graph id per node (or per edge: its receiver's) (query.jl:500-512)."""
    if edges:
        return gather(g.node_graph_id, g.receivers)
    return g.node_graph_id


def has_self_loops(g: GraphTuple) -> torch.Tensor:
    """Any edge with ``s == r`` (query.jl:553-560)."""
    no_edge_valid(g, "has_self_loops")
    return (g.senders == g.receivers).any()


def _edge_keys(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    return torch.sort(a * n + b).values


def has_multi_edges(g: GraphTuple) -> torch.Tensor:
    """Any ``(s, r)`` pair that appears twice (query.jl:562-568)."""
    no_edge_valid(g, "has_multi_edges")
    k = _edge_keys(g.senders, g.receivers, g.num_nodes)
    return (k[1:] == k[:-1]).any()


def is_bidirected(g: GraphTuple) -> torch.Tensor:
    """Every edge has its reverse (query.jl:570-579): the set of ``(s, r)``
    pairs equals that of ``(r, s)``. The JAX package compares the dense
    adjacency's support with its transpose; this needs no dense matrix."""
    no_edge_valid(g, "is_bidirected")
    n = g.num_nodes
    a = torch.unique(_edge_keys(g.senders, g.receivers, n))
    b = torch.unique(_edge_keys(g.receivers, g.senders, n))
    return torch.tensor(torch.equal(a, b), device=g.device)


def has_edge(g: GraphTuple, i: int, j: int) -> torch.Tensor:
    """Whether the edge ``i -> j`` exists (Graphs.has_edge)."""
    no_edge_valid(g, "has_edge")
    return ((g.senders == i) & (g.receivers == j)).any()


def has_isolated_nodes(g: GraphTuple, *, dir: str = "out") -> torch.Tensor:
    """Any node of degree 0 (Graphs.has_isolated_nodes)."""
    return (degree(g, dir=dir, edge_weight=False) == 0).any()


def is_directed(g: GraphTuple) -> bool:
    """Edges are always directed (an undirected graph holds both edges)."""
    return True


def get_graph_type(g: GraphTuple) -> str:
    """The representation: COO edges (with their CSR groupings)."""
    return "coo"


def khop_adj(g: GraphTuple, k: int, *, dtype=torch.float32) -> torch.Tensor:
    """``A^k`` (query.jl:587-589)."""
    A = adjacency_matrix(g, dtype=dtype)
    out = A
    for _ in range(k - 1):
        out = out @ A
    return out


def node_features(g: GraphTuple):
    """The single node feature tensor, else the dict (None when empty)
    (query.jl:516-528)."""
    if len(g.nodes) == 1:
        return next(iter(g.nodes.values()))
    return g.nodes or None


def edge_features(g: GraphTuple):
    if len(g.edges) == 1:
        return next(iter(g.edges.values()))
    return g.edges or None


def graph_features(g: GraphTuple):
    if len(g.globals_) == 1:
        return next(iter(g.globals_.values()))
    return g.globals_ or None


# ---- host-side neighbourhood queries ---------------------------------------

def adjacency_list(g: GraphTuple, *, dir: str = "out") -> list[list[int]]:
    """Each node's out-neighbours (``dir="out"``) or in-neighbours, in edge
    order (query.jl:176-206). Reads the edges to the host."""
    no_edge_valid(g, "adjacency_list")
    s = g.senders.cpu().numpy()
    r = g.receivers.cpu().numpy()
    a, b = (s, r) if dir == "out" else (r, s)
    out: list[list[int]] = [[] for _ in range(g.num_nodes)]
    for i, j in zip(a.tolist(), b.tolist()):
        out[i].append(j)
    return out


def outneighbors(g: GraphTuple, i: int) -> list[int]:
    """query.jl:116-136. Host-side."""
    return adjacency_list(g, dir="out")[i]


def inneighbors(g: GraphTuple, i: int) -> list[int]:
    """query.jl:138-157. Host-side."""
    return adjacency_list(g, dir="in")[i]
