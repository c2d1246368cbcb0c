"""Ranks of the port's multi-device tests: spawned processes on gloo.

Imported by the spawned ranks, so it imports no JAX: the JAX side of each
check runs in the test process and arrives here as numpy arrays (graphs,
inputs, JAX-initialised parameters), and each rank's results go back as a
``torch.save`` file per rank.

:func:`spawn` starts ``nprocs`` ranks (``torch.multiprocessing.spawn``,
the ``spawn`` start method), each with ``init_process_group("gloo")`` on a
free localhost port, runs ``fn(rank, *args)`` and returns the ranks'
results in rank order. :func:`run_cases` is the one worker: it runs every
case the test asks for on a graph mesh of all ranks and, for the training
cases, on a (data x graph) mesh.
"""

import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import graphneuralnetworks_tpu_torch as tgnn
from graphneuralnetworks_tpu_torch import models as TM
from graphneuralnetworks_tpu_torch import parallel as TP
from graphneuralnetworks_tpu_torch.interop import load_jax_params
from graphneuralnetworks_tpu_torch.ops import attention as TA

F64 = dict(device="cpu", dtype=torch.float64)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, nprocs, port, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=nprocs, rank=rank)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args) -> list:
    """``[fn(rank, *args) for each rank]``, each rank in its own process."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_entry, args=(fn, nprocs, _free_port(), out_dir, args),
                 nprocs=nprocs, join=True)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(nprocs)]


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---- the models, by name: (constructor, forward) ---------------------------

def _layer(name):
    """The port's layer ``name`` (float64, CPU), as the test builds its JAX
    twin."""
    return {
        "gcn": lambda: TM.GCNConv(16, 8, torch.relu, **F64),
        "gcn_w": lambda: TM.GCNConv(16, 8, use_edge_weight=True, **F64),
        "sage": lambda: TM.SAGEConv(16, 8, **F64),
        "gat": lambda: TM.GATConv(16, 4, heads=2, **F64),
        "gat_kernels": lambda: TM.GATConv(16, 4, heads=2, **F64),
        "graphconv_max": lambda: TM.GraphConv(16, 8, aggr="max", **F64),
        "dconv": lambda: TM.DConv(16, 8, 3, **F64),
        "dconv_w": lambda: TM.DConv(16, 8, 3, **F64),
        "chain_gcn_sage": lambda: TM.GNNChain(
            TM.GCNConv(6, 8, torch.relu, **F64), TM.SAGEConv(8, 3, **F64)),
        "chain_gcn_gat": lambda: TM.GNNChain(
            TM.GCNConv(6, 8, torch.relu, **F64),
            TM.GATConv(8, 8, heads=2, concat=False, **F64),
            torch.nn.Linear(8, 3, dtype=torch.float64)),
    }[name]()


def _graph(arrays):
    s, r, n, w = arrays
    return tgnn.graph(s, r, num_nodes=n, edge_weight=w, device="cpu")


def _local(pg, rank, a):
    """Part ``rank``'s rows of a global numpy array."""
    return torch.as_tensor(pg.scatter_nodes(np.asarray(a))[rank])


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()}


# ---- the cases -------------------------------------------------------------

def propagate_case(rank, mesh, c):
    """``make_sharded_propagate``: forward and the gradient of ``sum(y *
    t)`` in ``x``; the part's buffer and its owned ids."""
    g = _graph(c["graph"])
    pg = TP.partition_graph(g, mesh.size("graph"), parts=c["parts"],
                            split_local=c["split"])
    run = TP.make_sharded_propagate(mesh, pg, device="cpu")
    x = _local(pg, rank, c["x"]).requires_grad_()
    y = run(x)
    (y * _local(pg, rank, c["t"])).sum().backward()
    return {"owned": pg.owned[rank], "y": y.detach(), "gx": x.grad,
            "src_rows": run.graph.src_rows, "num_nodes": run.graph.num_nodes,
            "has_split": run.graph.split is not None}


def layer_case(rank, mesh, c):
    """``make_sharded_apply`` of a layer with the JAX parameters: forward,
    and the gradients of ``sum(y ** 2)`` over all parts in ``x`` and in the
    parameters (summed over ranks)."""
    g = _graph(c["graph"])
    pg = TP.partition_graph(g, mesh.size("graph"), parts=c.get("parts"),
                            with_reverse=c.get("with_reverse", False))
    layer = load_jax_params(_layer(c["layer"]), c["params"])
    kernels = c["layer"].endswith("_kernels")
    route = TA._kernel_route
    if kernels:   # the card's autograd functions on CPU tensors
        TA._kernel_route = lambda t: True
    try:
        run = TP.make_sharded_apply(mesh, pg, lambda sg, x: layer(sg, x),
                                    device="cpu")
        x = _local(pg, rank, c["x"]).requires_grad_()
        y = run(x)
        (y ** 2).sum().backward()
    finally:
        TA._kernel_route = route
    TP.all_reduce_grads(layer.parameters(), mesh.group("graph"))
    return {"owned": pg.owned[rank], "y": y.detach(), "gx": x.grad,
            "grads": _grads(layer), "src_rows": run.graph.src_rows,
            "num_nodes": run.graph.num_nodes,
            "has_split": run.graph.split is not None}


def _nll_loss(m, sg, x, y):
    logits = m(sg, x)
    ls = torch.log_softmax(logits, -1)
    nll = -ls.gather(-1, y.long()[:, None])[:, 0]
    mask = sg.node_mask.to(ls.dtype)
    return (nll * mask).sum(), mask.sum()


def train_case(rank, c):
    """``make_mesh_train_step`` on a mesh of ``c["mesh"]``: ``c["steps"]``
    steps of ``c["opt"]`` from the JAX parameters; the losses and the
    parameters after the first step and after the last."""
    shape, axes = c["mesh"]
    mesh = TP.Mesh(shape, axes)
    data_axis = "data" if "data" in axes else None
    graphs = [_graph(a) for a in c["graphs"]]
    gp = mesh.size("graph")
    pgs = [TP.partition_graph(g, gp, parts=p)
           for g, p in zip(graphs, c["parts"])]
    model = load_jax_params(_layer(c["model"]), c["params"])
    opt = (torch.optim.SGD(model.parameters(), lr=c["lr"]) if c["opt"] ==
           "sgd" else torch.optim.Adam(model.parameters(), lr=c["lr"]))
    replica = mesh.index("data") if data_axis else 0
    pg = pgs[replica]
    step = TP.make_mesh_train_step(
        model, opt, mesh, pgs if data_axis else pg, _nll_loss,
        data_axis=data_axis, device="cpu")
    part = mesh.index("graph")
    x = _local(pg, part, c["xs"][replica])
    y = torch.as_tensor(pg.scatter_nodes(c["ys"][replica])[part])
    losses, after = [], []
    for _ in range(c["steps"]):
        losses.append(float(step(x, y)))
        after.append({k: p.detach().clone()
                      for k, p in model.named_parameters()})
    return {"losses": losses, "first": after[0], "last": after[-1]}


def raises_case(rank, mesh, c):
    """A view without the reversed partition refuses ``reverse()`` and
    ``degree(dir="out")``; an out-degree with explicit weights refuses
    too."""
    g = _graph(c["graph"])
    pg = TP.partition_graph(g, mesh.size("graph"))
    sg = TP.shard_graph_local(pg, rank, mesh.group("graph"), device="cpu")
    out = {}
    for name, fn in (("reverse", sg.reverse),
                     ("out_degree", lambda: tgnn.degree(sg, dir="out"))):
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    sgr = TP.shard_graph_local(
        TP.partition_graph(g, mesh.size("graph"), with_reverse=True), rank,
        mesh.group("graph"), device="cpu")
    try:
        tgnn.degree(sgr, dir="out", edge_weight=torch.ones(sgr.num_edges))
        out["out_degree_weights"] = None
    except ValueError as e:
        out["out_degree_weights"] = str(e)
    out["degree_out"] = tgnn.degree(sgr, dir="out", dtype=torch.float64)
    out["degree_both"] = tgnn.degree(sgr, dir="both", dtype=torch.float64)
    out["owned"] = pg.owned[rank]
    return out


def run_cases(rank, cases):
    """Every case of ``cases`` (``{name: spec}``) on this rank; the graph
    cases on a graph mesh of all ranks."""
    mesh = TP.Mesh((dist.get_world_size(),), ("graph",))
    out = {}
    for name, c in cases.items():
        kind = c["kind"]
        if kind == "propagate":
            out[name] = propagate_case(rank, mesh, c)
        elif kind == "layer":
            out[name] = layer_case(rank, mesh, c)
        elif kind == "train":
            out[name] = train_case(rank, c)
        elif kind == "raises":
            out[name] = raises_case(rank, mesh, c)
    return out
