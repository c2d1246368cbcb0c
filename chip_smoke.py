#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure ends the run with a non-zero exit and no result line):

1. Environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   build of every kernel from ``graphneuralnetworks_tpu_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (N=131,072 nodes, E=2,000,000 edges, D=128, float32):
   K1 (``spmm_csr_f32``) and K2 (``spmm_sddmm_csr_f32``), forward and
   backward, with times (CUDA events), the plain version's time, a library
   yardstick (``torch.sparse.mm``) where one exists, and the least time the
   card could take (bytes over memory rate, operations over float32 rate).
3. The main path at full width: ``GNNChain(GCNConv(128, 128, relu),
   GCNConv(128, 8))`` trained with masked cross-entropy and Adam, 10 steps,
   with kernel launch counts; then the same with learned edge weights (the
   weighted backward, K2); then one forward and backward of each model on
   the card held against the same model on the CPU plain path.
4. The Cora accuracy bar on the card: GCN, GraphConv, SAGE and GIN, 40
   epochs, train accuracy > 0.94 and test accuracy > 0.69.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. ``--out DIR``
also writes every measurement to ``DIR/chip_smoke.json``; ``--profile``
adds a ``torch.profiler`` breakdown of three train steps.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N, E, D = 131_072, 2_000_000, 128
OUT_D = 8
STEPS = 10
CORA_EPOCHS = 40

# Published peaks (NVIDIA data sheets): memory bytes/s and float32 FLOP/s
# outside the tensor cores, by card name. The SXM part is the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}

# Tolerances, elementwise |kernel - plain| <= ATOL + RTOL * |plain|. Both
# sides sum the same float32 products in a different order (the kernel in
# CSR order, index_add_ with atomics), so they differ by rounding only.
RTOL, ATOL = 1e-5, 1e-4
# Card vs CPU for a whole model: cuBLAS and the CPU BLAS also order their
# sums differently. A weight gradient sums 131,072 per-node terms whose signs
# cancel (random labels), so its float32 rounding error relative to its norm
# is about eps * log2(N) * sqrt(N) = 6e-8 * 17 * 362 ~ 4e-4; gradients are
# compared by the norm of the difference against 1e-3.
MODEL_RTOL, MODEL_ATOL, GRAD_NORM_RTOL = 1e-4, 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def cuda_ms(fn, *, warmup: int = 3, batches: int = 11,
            per_batch: int = 10) -> float:
    """Median over ``batches`` of the mean time of one call, each batch of
    ``per_batch`` back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, *,
            rtol: float = RTOL, atol: float = ATOL) -> float:
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    got, ref = got.detach(), ref.detach()
    diff = (got.double() - ref.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / (ref.double().abs() + atol)).max()) if diff.numel() \
        else 0.0
    ok = bool((diff <= atol + rtol * ref.double().abs()).all())
    log(f"  {name:<34} max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"(rtol={rtol:g}, atol={atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    return err


def bound(bytes_: float, flops: float, card: str) -> tuple[float, str]:
    bw, fl = peaks(card)
    t_b, t_f = bytes_ / bw * 1e3, flops / fl * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---- phase 2 ---------------------------------------------------------------

def kernel_phase(gnn, g, card: str) -> dict:
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N, D, generator=gen, device=dev)
    dy = torch.randn(N, D, generator=gen, device=dev)
    w = torch.rand(E, generator=gen, device=dev) + 0.5
    x8 = torch.randn(N, OUT_D, generator=gen, device=dev)
    dy8 = torch.randn(N, OUT_D, generator=gen, device=dev)
    e8 = torch.randn(E, OUT_D, generator=gen, device=dev)
    x7 = torch.randn(N, 7, generator=gen, device=dev)
    ir, cr = g.indptr_r, g.col_r
    is_, cs, es = g.indptr_s, g.col_s, g.eid_s
    res = {"k1": {"err": 0.0, "variants": []}, "k2": {"err": 0.0,
                                                      "variants": []}}
    bw = peaks(card)[0]

    def k1_case(label, args, lib=None):
        indptr, col, eid, w_, src = args
        d = src.shape[1]
        y = S.spmm_csr(*args)
        ref = S.spmm_plain(*args)
        err = compare(f"K1 {label}", y, ref)
        res["k1"]["err"] = max(res["k1"]["err"], err)
        # compulsory bytes: indptr, col, eid, w, the source rows and the
        # output once each; with no reuse every edge reads a whole row
        idx = 4 * ((N + 1) + sum(E for t in (col, eid, w_) if t is not None))
        byt = idx + 4 * (src.shape[0] + N) * d
        no_reuse = idx + 4 * (E + N) * d if col is not None else byt
        b_ms, b_by = bound(byt, (1 if w_ is None else 2) * E * d, card)
        res["k1"]["variants"].append({
            "case": label, "d": d, "ms": cuda_ms(lambda: S.spmm_csr(*args)),
            "plain_ms": cuda_ms(lambda: S.spmm_plain(*args)),
            "library_ms": cuda_ms(lib) if lib is not None else None,
            "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": no_reuse / bw * 1e3, "max_abs_err": err})

    a_ones = torch.sparse_csr_tensor(ir, cr, torch.ones(E, device=dev),
                                     (N, N))
    a_w = torch.sparse_csr_tensor(ir, cr, w, (N, N))
    log("phase 2: kernels vs plain versions "
        f"(N={N}, E={E}, D={D}, float32)")
    k1_case("fwd receiver-CSR D=128", (ir, cr, None, None, x),
            lambda: torch.sparse.mm(a_ones, x))
    k1_case("fwd receiver-CSR weighted D=128", (ir, cr, None, w, x),
            lambda: torch.sparse.mm(a_w, x))
    k1_case("bwd sender-CSR D=128", (is_, cs, es, None, dy))
    k1_case("bwd sender-CSR weighted D=128", (is_, cs, es, w, dy))
    k1_case("fwd receiver-CSR D=8", (ir, cr, None, None, x8))
    k1_case("bwd sender-CSR D=8", (is_, cs, es, None, dy8))
    k1_case("gather-bwd edge rows D=8", (ir, None, None, None, e8))
    k1_case("fwd receiver-CSR D=7 (scalar path)", (ir, cr, None, w, x7))

    for d, xx, dd in ((D, x, dy), (OUT_D, x8, dy8)):
        args = (is_, cs, es, w, dd, xx)
        dx, dw = S.spmm_sddmm(*args)
        rdx, rdw = S.spmm_sddmm_plain(*args)
        err = max(compare(f"K2 dx D={d}", dx, rdx),
                  compare(f"K2 dw D={d}", dw, rdw))
        res["k2"]["err"] = max(res["k2"]["err"], err)
        # dy, x and dx rows; indptr, col, eid, w and dw entries
        byt = 4 * (3 * N * d + (N + 1) + 4 * E)
        b_ms, b_by = bound(byt, 4 * E * d, card)
        res["k2"]["variants"].append({
            "case": f"bwd sender-CSR D={d}", "d": d,
            "ms": cuda_ms(lambda: S.spmm_sddmm(*args)),
            "plain_ms": cuda_ms(lambda: S.spmm_sddmm_plain(*args)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": (byt + 4 * (E - N) * d) / bw * 1e3,
            "max_abs_err": err})

    # the autograd function end to end: forward K1, backward K2 / K1
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    y = gnn.ops.propagate(gnn.ops.e_mul_xj, g, "sum", xj=xr, e=wr)
    (y * dy).sum().backward()
    xp = x.clone().requires_grad_()
    wp = w.clone().requires_grad_()
    yp = S.spmm_plain(ir, cr, None, wp, xp)
    (yp * dy).sum().backward()
    compare("propagate(e_mul_xj) forward", y, yp.detach())
    compare("propagate(e_mul_xj) dx", xr.grad, xp.grad)
    compare("propagate(e_mul_xj) dw", wr.grad, wp.grad)

    for k in ("k1", "k2"):
        for v in res[k]["variants"]:
            lib = (f"{v['library_ms']:.4f}" if v["library_ms"] is not None
                   else "none")
            log(f"  time {k.upper()} {v['case']:<34} kernel={v['ms']:.4f} ms "
                f"plain={v['plain_ms']:.4f} ms library={lib} ms "
                f"bound={v['bound_ms']:.4f} ms ({v['bound_by']}) "
                f"no-reuse bound={v['no_reuse_bound_ms']:.4f} ms")
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return res


# ---- phase 3 ---------------------------------------------------------------

def gcn(M, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(M.GCNConv(D, D, torch.relu, generator=gen, device=dev),
                      M.GCNConv(D, OUT_D, generator=gen, device=dev))


def train(model, params, step_args, loss_fn, S, *, steps: int = STEPS):
    from graphneuralnetworks_tpu_torch.training import make_train_step

    opt = torch.optim.Adam(params, lr=1e-3)
    step = make_train_step(model, opt, loss_fn)
    torch.cuda.synchronize()
    S.launches.update(k1=0, k2=0)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*step_args)
        losses.append(float(loss))     # waits for the step to finish
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(S.launches)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses, times, launches, opt


def compare_model(name, model, g, x, args_fn, extra_params=()):
    """One forward+backward on the card vs the CPU plain path."""
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    cpu_model = copy.deepcopy(model).to("cpu")
    gc = g.to("cpu")
    out = {}
    results = []
    for m, gg, xx, extra in ((model, g, x, extra_params),
                             (cpu_model, gc, x.cpu(),
                              [p.detach().cpu().requires_grad_()
                               for p in extra_params])):
        m.zero_grad(set_to_none=True)
        for p in extra:
            p.grad = None
        logits = m(gg, xx, **args_fn(extra))
        loss = masked_cross_entropy(logits, gg.nodes["y"], gg.node_mask)
        loss.backward()
        grads = [p.grad for p in m.parameters()] + [p.grad for p in extra]
        results.append((logits.detach(), loss.detach(), grads))
    (lg, ls, gr), (lc, lsc, grc) = results
    out["logits_err"] = compare(f"{name}: logits card vs CPU", lg.cpu(), lc,
                                rtol=MODEL_RTOL, atol=MODEL_ATOL)
    compare(f"{name}: loss card vs CPU", ls.cpu().reshape(1),
            lsc.reshape(1), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    worst = 0.0
    for i, (a, b) in enumerate(zip(gr, grc)):
        rel = float((a.cpu().double() - b.double()).norm()
                    / b.double().norm().clamp(min=1e-30))
        worst = max(worst, rel)
        if not rel <= GRAD_NORM_RTOL:
            raise AssertionError(f"{name}: gradient {i} differs, |a-b|/|b|="
                                 f"{rel:.3e} > {GRAD_NORM_RTOL:g}")
    log(f"  {name}: {len(gr)} gradients card vs CPU, worst "
        f"|a-b|/|b|={worst:.3e} (limit {GRAD_NORM_RTOL:g}) ok")
    out["grad_rel_err"] = worst
    return out


def main_path_phase(g, profile: bool, out_dir) -> dict:
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    dev = g.device
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((N, D)),
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.random.default_rng(4).integers(0, OUT_D, N),
                        device=dev)
    g = g.with_nodes(y=y)
    mask = g.node_mask
    res = {}

    log("phase 3a: GCN train step (GCNConv(128,128,relu) -> GCNConv(128,8), "
        f"masked cross-entropy, Adam lr=1e-3), {STEPS} steps")
    model = gcn(M, 0, dev)

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    losses, times, launches, _ = train(model, model.parameters(),
                                       (g, x, y, mask), loss_fn, S)
    log(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f}; ms/step "
        f"median={statistics.median(times):.3f} "
        f"first={times[0]:.3f} all={[round(t, 3) for t in times]}")
    log(f"  launches over {STEPS} steps: {launches}")
    if launches != {"k1": 3 * STEPS, "k2": 0}:
        raise AssertionError(f"expected K1 3x and K2 0x per step, got "
                             f"{launches}")
    res["gcn"] = {"losses": losses, "ms_per_step": times,
                  "median_ms_per_step": statistics.median(times),
                  "launches": launches}

    if profile:
        res["profile"] = profile_steps(model, (g, x, y, mask), loss_fn,
                                       out_dir)

    log("phase 3b: the same GCN with learned edge weights "
        f"(weighted backward), {STEPS} steps")
    model_w = gcn(M, 1, dev)
    ew = torch.nn.Parameter(torch.ones(E, device=dev))

    def loss_w(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x, edge_weight=ew), y, mask)

    losses_w, times_w, launches_w, _ = train(
        model_w, list(model_w.parameters()) + [ew], (g, x, y, mask), loss_w,
        S)
    log(f"  loss {losses_w[0]:.6f} -> {losses_w[-1]:.6f}; ms/step "
        f"median={statistics.median(times_w):.3f}")
    log(f"  launches over {STEPS} steps: {launches_w}")
    if launches_w["k2"] != 2 * STEPS or launches_w["k1"] != 2 * STEPS:
        raise AssertionError(f"expected K1 2x and K2 2x per step, got "
                             f"{launches_w}")
    res["gcn_learned_edge_weight"] = {
        "losses": losses_w, "ms_per_step": times_w,
        "median_ms_per_step": statistics.median(times_w),
        "launches": launches_w}

    log("phase 3c: one forward+backward on the card vs the CPU plain path")
    res["vs_cpu"] = {
        "gcn": compare_model("GCN", model, g, x, lambda extra: {}),
        "gcn_learned_edge_weight": compare_model(
            "GCN learned edge weights", model_w, g, x,
            lambda extra: {"edge_weight": extra[0]}, [ew]),
    }
    return res


def profile_steps(model, args, loss_fn, out_dir) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    from graphneuralnetworks_tpu_torch.training import make_train_step

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, opt, loss_fn)
    step(*args)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if (not str(ev.device_type).endswith("CUDA")
                or getattr(ev, "is_user_annotation", False)):
            continue   # ranges, not kernels: their time is their kernels'
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3 / 3, ev.count // 3, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile (3 steps): wall {wall / 3:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step ({100 * busy / (wall / 3):.1f}%)")
    for ms, cnt, key in rows[:20]:
        log(f"    {ms:9.4f} ms/step  x{cnt:<4} {key[:90]}")
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    return {"wall_ms_per_step": wall / 3, "device_ms_per_step": busy,
            "top": [{"ms_per_step": ms, "calls_per_step": c, "name": k}
                    for ms, c, k in rows[:30]]}


# ---- phase 4 ---------------------------------------------------------------

def cora_phase(dev) -> dict:
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.data import load_cora
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S
    from graphneuralnetworks_tpu_torch.training import (
        make_train_step, masked_accuracy, masked_cross_entropy)

    data, is_real = load_cora(seed=1, device=dev)
    g = data.graph
    x, y = g.x, g.nodes["y"]
    din, nh, nout = x.shape[1], 16, data.num_classes
    log(f"phase 4: Cora bar on the card ({'real' if is_real else 'synthetic'}"
        f" Cora, {g.num_nodes} nodes, {g.num_edges} edges), "
        f"{CORA_EPOCHS} epochs")

    def build(name, gen):
        kw = dict(generator=gen, device=dev)
        head = torch.nn.Linear(nh, nout, device=dev)
        if name == "GCN":
            return M.GNNChain(M.GCNConv(din, nh, torch.relu, **kw),
                              M.GCNConv(nh, nh, torch.relu, **kw), head)
        if name == "GraphConv":
            return M.GNNChain(M.GraphConv(din, nh, torch.relu, **kw),
                              M.GraphConv(nh, nh, torch.relu, **kw), head)
        if name == "SAGE":
            return M.GNNChain(M.SAGEConv(din, nh, torch.relu, **kw),
                              M.SAGEConv(nh, nh, torch.relu, **kw), head)
        return M.GNNChain(M.GINConv(M.MLP([din, nh], **kw), 0.01),
                          M.GINConv(M.MLP([nh, nh], **kw), 0.01), head)

    out = {"real_dataset": is_real}
    for name in ("GCN", "GraphConv", "SAGE", "GIN"):
        torch.manual_seed(17)
        model = build(name, torch.Generator().manual_seed(17))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = make_train_step(
            model, opt,
            lambda m, g, x, y, mask: masked_cross_entropy(m(g, x), y, mask))
        S.launches.update(k1=0, k2=0)
        for _ in range(CORA_EPOCHS):
            step(g, x, y, data.train_mask)
        launches = dict(S.launches)
        with torch.no_grad():
            logits = model(g, x)
        tr = float(masked_accuracy(logits, y, data.train_mask))
        te = float(masked_accuracy(logits, y, data.test_mask))
        log(f"  {name:<10} train acc {tr:.4f} test acc {te:.4f} "
            f"launches {launches}")
        if not (tr > 0.94 and te > 0.69):
            raise AssertionError(f"{name}: Cora bar missed (train {tr}, "
                                 f"test {te})")
        if launches["k1"] == 0:
            raise AssertionError(f"{name}: K1 never launched")
        out[name] = {"train_acc": tr, "test_acc": te, "launches": launches}
    return out


# ---- main ------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (and the trace)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the train step")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import graphneuralnetworks_tpu_torch as gnn
    from graphneuralnetworks_tpu_torch.ops.cuda import build as B

    pkg_dir = os.path.dirname(os.path.abspath(gnn.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        raise RuntimeError(f"imported the package from {pkg_dir}, not from "
                           f"this checkout")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card_line = smi("name,power.limit")
    card = torch.cuda.get_device_name(0)
    log(f"phase 1: {card_line} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | Python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    B.build_all()
    build_s = time.perf_counter() - t0
    log(f"  kernel build: {build_s:.2f} s ({', '.join(B.SOURCES)})")
    for name, text in B.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    g = gnn.rand_graph(N, E, seed=1)
    torch.cuda.synchronize()
    log(f"  graph build: {time.perf_counter() - t0:.2f} s "
        f"({g.num_nodes} nodes, {g.num_edges} edges)")

    kern = kernel_phase(gnn, g, card)
    main_res = main_path_phase(g, args.profile, args.out)
    cora = cora_phase(g.device)

    def entry(key, name, line, launches):
        head = kern[key]["variants"][0]
        return {"name": name, "route": "cuda",
                "source": "graphneuralnetworks_tpu_torch/csrc/spmm.cu",
                "replaces": f"graphneuralnetworks_tpu/ops/pallas/spmm.py:"
                            f"{line}",
                "launches": launches, "max_abs_err": kern[key]["err"],
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "case": head["case"]}

    kernels = [
        entry("k1", "spmm_csr_f32", 256, main_res["gcn"]["launches"]["k1"]),
        entry("k2", "spmm_sddmm_csr_f32", 331,
              main_res["gcn_learned_edge_weight"]["launches"]["k2"]),
    ]
    total_s = time.perf_counter() - t_start
    log(f"total {total_s:.1f} s")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card_line, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "kernels": kern, "main_path": main_res,
                       "cora": cora, "total_s": total_s}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
