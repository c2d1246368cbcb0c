#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure ends the run with a non-zero exit and no result line):

1. Environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   build of every kernel from ``graphneuralnetworks_tpu_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (N=131,072 nodes, E=2,000,000 edges, D=128, float32):
   K1 (``spmm_csr_f32``: every case a phase-3 path launches, each row
   naming the paths, the gathers' backward over ``[E, D]`` edge rows at
   EdgeConv's D=128 and 3v's 64, 48, 32, 24 and 3, ChebConv's power iteration at D=1 and the forward over ``g.reverse()``'s
   receiver CSR through its edge-id map included) and K2
   (``spmm_sddmm_csr_f32``, also at D=32 and 8 and at GAT (b)'s H=4, D=32
   in one launch with dropped attention weights), forward and backward,
   with times (CUDA events), the plain version's time, a library
   yardstick (``torch.sparse.mm``) where one exists, and the least time the
   card could take (bytes over memory rate, operations over float32 rate).
   2b: the attention kernels K12 (``edge_softmax_f32``), K3
   (``gat_softmax_f32``), K4 (``gat_bwd_dpi_f32``) and K5
   (``gat_bwd_rev_f32``) the same way, at the GAT path's per-head shapes
   (H, D) = (4, 32) and (1, 8); K12 also with dropout masks and with edge
   values. No single PyTorch call computes these, so no library time.
   2c: GATv2's kernels K9 (``gatv2_softmax_f32``), K10
   (``gatv2_bwd_dq_f32`` with ``gatv2_da_reduce_f32``: ``dq`` and ``da``)
   and K11 (``gatv2_bwd_rev_f32``) the same way, at the GATv2 path's
   per-head shapes (H, O) = (4, 32) and (1, 8).
   2d: dot attention's kernels K6 (``dot_softmax_f32``), K7
   (``dot_bwd_dq_f32``) and K8 (``dot_bwd_rev_f32``) at (H, O, D) =
   (4, 32, 32) (Transformer layer 1), (1, 8, 8) (its head layer) and
   (1, 128, 128) (AGNN), and with a leaky_relu slope at (4, 32, 32).
   2e: K13 (``sddmm_csr_f32``) at D = 32, 128 and 512 and at (H, D) =
   (4, 32), its backward (K1 twice) against the plain autograd, with the
   library yardstick ``torch.sparse.sampled_addmm`` (batched over the
   heads at H=4) and the plain two-gather ``xi_dot_xj`` beside it.
   2f: K14 (``segment_max_csr_f32``, max and min) and its backward
   (``segment_max_bwd_csr_f32``) over the receiver CSR at F = 128
   (EdgeConv layer 1's messages), 8 (its head layer) and 4 (``[E, H]``
   logits, H=4), and over the graph CSR of the 3k batch at F = 64, on
   values rounded to a grid of 1/4 (exact ties) with a NaN entry and with
   rows emptied (checked against the plain versions bit for bit); timed
   beside the plain version, the library yardstick
   ``torch.segment_reduce(data, "max", offsets=indptr)`` and
   ``scatter_reduce("amax")``.
   2h: the bfloat16 kernels (``spmm_csr_bf16``, ``spmm_sddmm_csr_bf16``,
   ``gat_softmax_bf16``, ``gat_bwd_dpi_bf16``, ``gat_bwd_rev_bf16``,
   ``gatv2_softmax_bf16``, ``gatv2_bwd_dq_bf16``, ``gatv2_bwd_rev_bf16``,
   ``dot_softmax_bf16``, ``dot_bwd_dq_bf16``, ``dot_bwd_rev_bf16``,
   ``edge_softmax_bf16``, ``sddmm_csr_bf16``, ``segment_max_csr_bf16``,
   ``segment_max_bwd_csr_bf16``): K1 over the receiver CSR at D = 128
   (bench.py's ``large_pallas_bf16``) and 8, over the sender CSR at D =
   128 and 8 and weighted at D = 128, over ``[E, D]`` edge rows at D = 128
   and 8 and by edge id over the sender CSR at D = 128; K2 at D =
   128, 8 and (H, D) = (4, 32) and (4, 128) in one launch (one case on
   each path of its chooser); K3, K4 and K5 at (4, 32),
   (1, 8) and (1, 128) (bench.py's ``attention_bf16``); K9, K10 (``dq``;
   its float32 ``da`` against the plain version in float64, as 2c) and
   K11 at (H, O) = (4, 32) and (1, 8); K6 (writing the raw logits), K7
   (from them) and K8 at 2d's (H, O, D) = (4, 32, 32), (1, 8, 8), (1, 128,
   128) (K6 and K7 in rows) and (4, 32, 32) with a slope, and at (1, 264,
   264) (K6 and K7 in strips), each at the layout its chooser gives
   (logged: bfloat16 K6's, K7's and K8's tables of their own, K8's staged
   kernel reading the receiver scalars packed); K12 at (4, 32)
   with node values, with them and a dropout mask, with edge values and
   the mask, and at (1, 8) with the mask; K13 at D = 128, 32 and (4, 32);
   each held to its plain version within one bfloat16 ulp; K14 (max, min)
   and its backward at F = 128, 8, 4 and over the 3k batch's graph CSR at
   F = 64, bit for bit with ties, a NaN and empty rows, as 2f; each timed
   beside the float32 kernel on the same values (device ms) and beside
   ``torch.sparse.mm`` (K1), ``torch.sparse.sampled_addmm`` (K13) or
   ``torch.segment_reduce`` (K14) in bfloat16 where it runs.
   Every timed row of phase 2 has ``ms`` (CUDA events around 10
   back-to-back calls: the host's gaps between launches count),
   ``device_ms`` (the kernels' own time per call from ``torch.profiler``),
   ``host_us`` (the wrapper's host time per call, no synchronise among the
   calls), and for a library yardstick its ``library_ms`` and
   ``library_device_ms``.
3. The main paths at full width, each trained with Adam for 10 steps, with
   the kernel launch counts of exactly those steps; masked cross-entropy
   unless said otherwise: ``GNNChain(GCNConv(128, 128, relu),
   GCNConv(128, 8))`` (3a); the same with learned edge weights (3b, the
   weighted backward K2); ``GNNChain(GATConv(128, 32, relu, heads=4),
   GATConv(128, 8, heads=1, concat=False))`` without attention dropout
   (3d: K3, K4, K5) and with dropout 0.6 in training mode (3e: K12, and K2
   in its backward, once per layer for all heads);
   ``GNNChain(GATv2Conv(128, 32, relu, heads=4),
   GATv2Conv(128, 8, heads=1, concat=False))`` (3f: K9, K10, K11);
   ``GNNChain(TransformerConv(128, 32, heads=4), TransformerConv(128, 8,
   heads=1, concat=False))`` (3g: K6, K7, K8); ``GNNChain(Linear(128,
   128), relu, AGNNConv(), AGNNConv(), Linear(128, 8))`` (3h: K6, K7, K8);
   link prediction, a GCN encoder ``GNNChain(GCNConv(128, 128, relu),
   GCNConv(128, 128))`` with ``DotDecoder`` on the 2M edges and on 2M
   negative edges, binary cross-entropy (3i: K13, and K1);
   ``GNNChain(EdgeConv(MLP([256, 128])), relu, EdgeConv(MLP([256, 8])))``
   with max aggregation (3j: K14 and its backward, K1 as the endpoint
   gathers' backward); graph classification, examples/
   graph_classification.py's model (``GraphConv(7, 64, relu)``,
   ``GraphConv(64, 64, relu)``, ``GlobalPool("max")``, ``Linear(64, 2)``)
   on one ``batch`` of 4,096 ``synthetic_tudataset`` graphs, graph-level
   cross-entropy (3k: K1, K14 over the graph CSR). 3c holds one
   forward and backward of the GCN models, of GAT (3d), GATv2 (3f),
   Transformer (3g, also with virtual self-loops and with edge features,
   whose route is K12), AGNN (3h) and the link step (3i) on the card
   against the same model on the CPU plain path in float64, and GAT's and
   GATv2's attention with one set of dropout masks for both sides (K12, and
   K2 once for all heads); also EdgeConv (3j), graph classification (3k) with
   ``GlobalPool`` max and mean, ``GlobalAttentionPool``, ``Set2Set`` and
   ``TopKPool`` on the 3k batch, ``softmax_edge_neighbors`` at H=4 and
   ``GraphConv(aggr="max")`` on the main graph. 3l: the conv zoo's
   propagation rows (``benchmarks/zoo_sweep_r5.py:44-67``) as
   ``GNNChain(L(128, 128), relu, L(128, 8))``: ChebConv k=3 with
   ``lambda_max=2.0`` and by default (a power iteration of 50 SpMMs at D=1
   in every call), SGConv k=2, TAGConv k=3, DConv k=2 on the graph and on
   its ``reverse``, ResGatedGraphConv, and ``GatedGraphConv(128, 2)`` then
   ``Linear(128, 8)`` (all K1), each trained and held card vs CPU as 3c
   holds the others, with DConv also on the reverse of a weighted graph.
   3v: the edge-featured layers, each twice at its published model's
   widths with Adam for 10 steps, profiled (the ``index_add`` sums of
   their edge messages apart), K1 (their endpoint gathers' backward)
   asserted, peak memory: ``NNConv(64, 64, MLP([5, 128, 4096]), relu,
   aggr="mean")`` (MPNN on QM9) on ``rand_graph(N, 500,000)`` with 5 edge
   features, ``CGConv(64, 64, softplus, edge_features=41, residual=True)``
   (CGCNN), ``GMMConv(128, 16, relu, K=3)`` then ``GMMConv(16, 8, K=3)``
   on MoNet's degree pseudo-coordinates, ``MEGNetConv(phi_e=MLP([96, 64,
   32]), phi_v=MLP([64, 64, 32]))`` (MEGNet, 100 edge features through a
   Linear to 32) and ``EGNNConv(128, 128, hidden_size=128)`` (EGNN on QM9,
   3-D positions), a Linear from 128 first where the width differs and a
   head to 8; the loss reads every output (MEGNet's edges and EGNN's
   positions by their mean square). One step each card vs CPU in float64
   on ``rand_graph(16,384, 262,144)`` (NNConv's 65,536 edges), every
   output, the relus' masks of the card replayed on the CPU.
   3o: ten paths in ``models.Precision`` (bfloat16 compute, float32
   master parameters and Adam), each with its float32 phase's model and
   graph, a float32 loss of the bfloat16 output, 10 steps each, profiled,
   only bfloat16 variants launched: 3a's GCN (K1 3 a step), 3d's GAT (K3,
   K4, K5 2 each), 3f's GATv2 (K9 2, K10 4, K11 2), 3g's Transformer and
   3h's AGNN (K6, K7, K8 2 each), 3b's GCN with learned
   edge weights (K1 2, K2 2), 3e's
   GAT with attention dropout 0.6 (K12 2, K2 2), 3i's link step (K13 2,
   K1 7), 3j's EdgeConv (K14 2, its backward 2, K1 2) and 3k's graph
   classification (K1 3, K14 1, its backward 1); one step of each card vs
   CPU in bfloat16 and in float64 (the card's dropout masks replayed on
   the CPU), and every parameter gradient float32.
   3p: heterogeneous graphs, ``benchmarks/hetero_temporal_bench_r5.py:
   57-111``: two node types of 65,536 nodes, three relations of 350,000
   uniform edges each (``user rates item``, ``item rated_by user``, ``user
   follows user``), ``HeteroGraphConv({rates: SAGEConv(128, 128),
   rated_by: SAGEConv(128, 128), follows: GraphConv(128, 128)})``: the
   forward and the forward and backward through ``x_user`` timed (host
   median, device ms), 10 Adam steps on the layer and ``x_user`` with the
   benchmark's loss, profiled, K1 3 times a forward and 5 a step (one
   backward per relation from ``user``); one step card vs CPU in float64.
   3q: recurrences, ``:115-137``: ``GNNRecurrence(TGCNCell(128, 128))`` and
   ``GNNRecurrence(GConvGRUCell(128, 128, 2))`` over T = 8 steps on
   ``rand_graph(65,536, 1,000,000, seed=2)``: each forward timed, GConvGRU
   with its default λ_max (one ``cheb_lambda_max``, 51 K1 launches at D =
   1, a call) and with ``lambda_max=`` computed once (48 at D = 128), both
   profiled; 10 Adam steps of TGCN on a regression loss (72 K1 a step);
   TGCN and GConvGRU card vs CPU in float64 over the first 2 steps, and
   GConvLSTM, DCGRU, EvolveGCNO and A3TGCN at d = 16 over T = 8, forward
   and backward, card vs CPU with their K1 launches; TGCN over
   ``TemporalGraph.from_snapshots(uniform=True)`` of three snapshots of
   16,384, 14,336 and 12,288 nodes (padded to one size, the pad edges
   invalid), card vs CPU with its K1 launches. Before them, 2i holds
   K1 at their shapes to the plain version and ``torch.sparse.mm`` and
   times it: 3p's relation receiver CSR at D = 128 and its sender CSR cut
   to the ``user`` rows, 3q's receiver CSR at D = 128 and D = 1 and its
   sender CSR at D = 128.
   3m and 3n: bench.py's north star, neighbor-sampled GraphSAGE at
   ogbn-products scale (its synthetic analog, bench.py:387-464: N =
   2,449,029, E = 123,718,280, skewed in-degrees, 196,615 train seeds, X
   ``[N, 100]`` class prototypes with noise, 47 classes; the in-CSR built
   on the card), ``GNNChain(SAGEConv(100, 256, relu), SAGEConv(256, 256,
   relu), Linear(256, 47))``, batch 1024, fanouts (15, 10), Adam at 1e-3,
   cross-entropy over the seed rows: 3m over ``NeighborLoader`` (the C++
   sampler, batches grouped on the card) through ``Prefetcher(size=4,
   workers=1)``, 10 warm-up batches then a window of 30; 3n over
   ``DeviceSampler.sample_blocks`` and ``apply_blocks``, 5 then 40. Each
   prints ms per batch, sampled edges per second, the set-up seconds, the
   losses (which must fall) and K1's three launches a step; 3m also the
   sampler's host ms per batch and utilisation. 3c holds one step of each
   card vs CPU, and ``sample`` against ``sample_blocks`` on the seed rows.
   Before them, 2g holds K1 at their shapes to the plain version and
   ``torch.sparse.mm`` and times it: 3n's block 0 receiver CSR at D = 100,
   block 1's at D = 256 and its sender CSR at D = 256 (weighted by the
   edge validity), 3m's batch graph at D = 100 and 256 forward and 256
   backward.
   2l, 3w, 3x: the receiver-order kernels over ``graph.csr_view``, the
   reversed graph's groupings read through their edge-id maps and an
   ``edge_valid`` graph's CSRs compacted to its valid edges. 2l holds K3
   (also bfloat16), K4, K5, K12, K9-K11, K6-K8, K13 and K14 and its
   backward (also bfloat16) over the main graph's reverse (3d's, 3f's,
   3g's and 3j's widths) and over block 0 of a 3n draw without
   replacement (3n's own draws have no invalid edge on this graph; 3w's
   widths) to plain computations over the receiver ids of the edges that
   count, and times them with the view's build. 3w trains GAT (PyG's
   examples/ogbn_products_gat.py widths, 100 -> 4 heads x 128 -> 47, 2 of
   its 3 hops) and SAGE with max aggregation (3n's widths) over such
   draws, 10 Adam steps each with their launches, one draw card vs CPU.
   3x trains 3d's GAT and 3j's EdgeConv on ``g.reverse()``, 5 steps each
   with their launches and device ms, one step card vs CPU.
4. The Cora accuracy bar on the card: GCN, GraphConv, SAGE, GIN, GAT,
   GATv2, ResGated and Transformer, 40 epochs, train accuracy > 0.94 and
   test accuracy > 0.69.
5. The examples that run on the graph toolkit and the data layer. 3r:
   examples/link_prediction.py on the main graph: ``rand_edge_split(g,
   0.9)`` (pairs kept together), 3i's ``LinkModel`` trained for 10 Adam
   steps at the example's 1e-2, each on a fresh ``negative_sample`` of the
   training graph (as many as its edges, one generator) built on the card,
   binary cross-entropy, the held-out link accuracy after steps 1 and 10
   (the training edges' mean logit must exceed the negatives' and that of
   their ends re-paired at random by 5 standard errors; on this uniform
   random graph the held-out edges carry no signal); the split's
   seconds, the draw's host ms apart from its graph build, ms per step
   with and without the draw, K13 2 and K1 7 launches a step,
   the steps profiled, one step card vs CPU in float64 on the same
   negatives. Before it, 2j holds K13 over the negatives' receiver CSR at
   D = 128 (against ``torch.sparse.sampled_addmm``), its backward K1 over
   their receiver and sender CSRs, and K1 over the training graph's two
   CSRs (against ``torch.sparse.mm``) to their plain versions, timed, also
   after an L2 flush. 3s: examples/graph_classification.py's loop as it
   stands: ``synthetic_tudataset(188)``, two ``DataLoader``s (batch 32, 2
   size buckets, the training one shuffled; a bucket's short batch filled
   with empty graphs) built on the card, ``GraphConv(7, 64, relu)``,
   ``GraphConv(64, 64, relu)``, ``GlobalPool("mean")``, ``Linear(64, 2)``,
   Adam at 1e-3 for 30 epochs; ms per batch, the loader's host ms per
   batch, K1's 3 launches a batch, the train and test accuracy, the steps
   profiled, one short batch (fillers included) card vs CPU in float64.
6. The multi-device path (``parallel/``) on ``benchmarks/scaling.py``'s
   defaults (:64-76, :120-140): its ``community`` graph (a copy of its
   ``make_graph``: N = 65,536, E = 1,000,000, 64 hidden communities), D =
   128, parts from ``partition_nodes``. Every rank runs in a process of its
   own (the ``spawn`` start method) on the one card: these are several
   ranks sharing one card, a test of correctness, not of scaling. 2k: K1
   at the shapes of the P = 4 parts (each part's receiver CSR over its
   halo buffer, part 0's sender CSR, owned and remote halves, and the
   backward of the gather of its shipped rows) against the plain version
   and ``torch.sparse.mm``, timed. 3t: ``make_sharded_propagate`` at P = 1
   (nccl), 2 and 4 (gloo: nccl refuses two ranks on one device; gloo takes
   the CUDA tensors and stages them through the host itself), the split
   path and the combined one: one step gathered against the single-card
   ``propagate(copy_xj)``, ms per step over 10 chained steps (the slowest
   rank), cut fraction, halo bytes, K1 launches per rank. 3u:
   ``make_mesh_train_step`` on a (data 2 x graph 2) mesh of 4 gloo ranks
   over two community graphs (seeds 0 and 1), 3a's GCN and the dryrun's
   ``GCNConv(128, 128, relu)``, ``GATConv(128, 128, heads=2,
   concat=False)``, ``Linear(128, 8)`` (``__graft_entry__.py:38-146``),
   one model after the other in one spawn of the ranks, 10
   Adam steps timed by ``profiling.StepTimer``: losses and parameters
   against one card training the same model on both graphs, K1/K3/K4/K5
   launches per rank, a checkpoint after step 5 restored into fresh
   modules and optimizers that repeat steps 6-10 bit for bit, and 3
   profiled steps under ``profiling.trace`` (a non-empty trace per rank;
   the ranks' kernel time over the wall: the card's busy share).

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. ``--out DIR``
also writes every measurement to ``DIR/chip_smoke.json``; ``--profile``
adds a ``torch.profiler`` breakdown of three train steps of GCN (3a, 3b),
of GAT (3d, 3e), GATv2 (3f), Transformer (3g), AGNN (3h), link prediction
(3i), EdgeConv (3j), graph classification (3k) and each 3l model (3v's
always), and of
three batches of 3m and of 3n (sampling included), with
the device time per step of each kernel of :data:`STEP_KERNELS` (K1-K12).
``--sweep`` times K1-K12, K14 and its backward at every layout (the
measurement behind the wrappers' choices; each layout but K14's held to
the plain version first), K1's gather-rate ceiling at D=128, and K1, K2,
K6, K7, K8 and K11 at every rows per warp and K10, K5, K9, K3, K4 and K12
at one row per warp on an R-MAT graph of skewed degrees, and the
bfloat16 K1, K2, K3-K8 at every layout of their sweep build
(``bf16``; K6 and K8 also alone, ``bf16_dot``, K6's rows against strips
on tables of 32 to 128 MiB, ``bf16_strips``, K7, ``bf16_k7``, and K2,
``bf16_k2``, each with a summary of the fastest, chosen and parent
layouts) (``--sweep k12,k4,skew`` runs the named sweeps only; with k1,
K1 also at 2g's shapes); the log ends with the seconds each phase took;
``--only 2e,2f`` runs phase 1 and the named phases only (kernel phases,
and the train phases 3b, 3d, 3e, 3f, 3l, 3v, 3o, 3p, 3q, 3s, 2j, 3r, 3m
and 3n, with ``--profile`` their profiles; 3v, 3o, 3p, 3q, 3r and 3s
always profile, and with ``--profile`` 3r also breaks the host's split and draw
down by function under ``cProfile``; ``--only 3p,3q`` runs 2i with
them, ``--only 3m,3n`` 2g, ``--only 2l,3w,3x`` the views' phases with
3n's set-up, ``--only 2j,3r,3s`` the examples' phases,
``--only 2k,3t,3u`` the multi-device path:
this script copied into an older checkout profiles that checkout's
steps), and prints no result line.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N, E, D = 131_072, 2_000_000, 128
OUT_D = 8
GAT_HEADS = 4
STEPS = 10
CORA_EPOCHS = 40
# the graph-classification batch (3k): synthetic_tudataset graphs of 7
# one-hot features, examples/graph_classification.py's hidden width
TUD_GRAPHS, TUD_FEATURES, TUD_HIDDEN = 4096, 7, 64

# Published peaks (NVIDIA data sheets): memory bytes/s and float32 FLOP/s
# outside the tensor cores, by card name. The SXM part is the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}

# Tolerances, elementwise |kernel - plain| <= ATOL + RTOL * |plain|. Both
# sides sum the same float32 products in a different order (the kernel in
# CSR order, index_add_ with atomics), so they differ by rounding only.
RTOL, ATOL = 1e-5, 1e-4
# Card vs CPU for a whole model: the card in float32 against the same model
# on the CPU plain path in float64, so that only the card's rounding counts
# (a float32 CPU side added its own, which moves with the host's BLAS: GATv2
# read 1.2e-4 and 9.5e-4 in two runs of the same code). A weight gradient
# sums 131,072 per-node terms whose signs cancel (random labels), so its
# float32 rounding error relative to its norm is about eps * log2(N) *
# sqrt(N) = 6e-8 * 17 * 362 ~ 4e-4; gradients are compared by the norm of
# the difference against 1e-3.
MODEL_RTOL, MODEL_ATOL, GRAD_NORM_RTOL = 1e-4, 1e-4, 1e-3
# GATv2's weight gradients also cross leaky_relu's kink: raw = q[r] + k[s]
# over E*H*O = 256M elements, with q and k from float32 GEMMs (rounding
# ~7e-7 at |raw| ~ 1.4), so ~256M * 2 * 7e-7 / (1.4 * 2.5) ~ 100 of them
# land on the other side of 0 than in float64, each moving one term of
# dense_i's gradient by 0.8 * dlg * a. Against a norm of ~sqrt(2M) such
# terms that is ~1.3 * sqrt(100 / 128) / sqrt(2M) ~ 8e-4 (measured 1.0e-3
# on an H100 at 700 W; GAT, with 32x fewer kink elements, 4e-5). GATv2's
# model check is held to 10x that.
GATV2_GRAD_NORM_RTOL = 1e-2
# K10's da [O, H] sums one term per edge, 2M of them, of either sign
# (|term| ~ 0.4, |da| up to ~1,200 at (4, 32)). A float32 sum's error is a
# random walk of steps eps/2 * |running sum| over its chain: ~1e-2 for
# cuBLAS's long chains in the plain einsum (measured 8.5e-3 against the
# kernel), under 1e-3 for the kernel's (~1,500 terms per warp, then ~1,300
# warp shares per head). So the kernel's da is held to the plain version run
# in float64 on the same inputs, elementwise within DA_ATOL_REL * max|da|
# (~1.2e-2) besides RTOL: ~25x the kernel's expected error. The error does
# not shrink with one entry's |da|, so the atol follows the array's scale.
DA_ATOL_REL = 1e-5
# The key bias of a TransformerConv (W4.bias) shifts every logit of a
# receiver's softmax, the self logit <q[r], k[r]> too, by the same
# <q[r], b>, which the softmax does not see: its gradient is 0 in exact
# arithmetic and float rounding on both sides (~1e-8 against ~1e-17), so
# |a-b|/|b| says nothing.
# Such a gradient is held to the model's largest gradient norm instead:
# |a-b| <= GRAD_NORM_RTOL * ZERO_GRAD_FLOOR * max |grad|.
ZERO_GRAD_FLOOR = 1e-3
# EdgeConv (3j) card vs CPU: a max aggregation routes each output's
# cotangent to one edge, and the card's float32 messages (a GEMM over
# [x_i; x_j - x_i], 256 wide: rms rounding 3.7e-7 at a spread of 1.41,
# measured against float64 at layer 1's shapes) can reorder a receiver's
# top two of ~15 candidates. The top gap of 15 draws has density ~2.2 /
# sigma at 0, so a maximum flips with probability ~2.2 * 3.7e-7 / (1.41 *
# sqrt(pi)) ~ 4.5e-7: ~7.5 of layer 1's N * 128 = 16.7M maxima, ~0.9 of
# layer 2's 1M. A flip sends dy[r, c] to another in-edge of r, moving row c
# of layer 1's weight gradient by dy * (x_j' - x_j) (norm ~16 |dy|) against
# a gradient norm of ~|dy| sqrt(N * 128 * 384) ~ 8.0e4 |dy|: 2.0e-4 per
# flip, ~5.5e-4 for 7.5 flips; one flip of layer 2 moves its gradient by
# ~4.7e-4. EdgeConv's model check is held to 10x that. Exact ties (equal
# values on both sides) split their cotangent the same way on both.
EDGECONV_GRAD_NORM_RTOL = 5e-3
# bfloat16 (2h, 3o). Its unit roundoff is u = 2^-8: rounding to nearest
# moves a value by at most u of its size, and one ulp is 2u. 2h: a bfloat16
# kernel and its plain version each round one float32 sum, taken in another
# order (float32: ATOL), so the results may land one ulp apart: |kernel -
# plain| <= one bfloat16 ulp of |plain| + ATOL; float32 outputs (the softmax
# state) at RTOL / ATOL. 3o, a Precision model's step card vs CPU: count,
# along a path through a layer, the bfloat16 results the card and the CPU
# may round differently (a float32 sum in another order, or inputs already
# apart): GCNConv's c = rsqrt(deg + 1), x * c, the SpMM, agg + x, * c, the
# dense product and + bias, 7; GATConv's dense product, pi, pj, pi + pj,
# leaky_relu, the attention sum (num), its normalisation (out), + bias and
# the mean over heads, 9. Each moves a value by at most u of the values'
# scale on each side, and the layers' gains are about 1 (normalised
# propagation and attention, Glorot weights), so R such roundings on a path
# through the model put the output within 2R u of max |output| of the
# CPU's bfloat16 path (both sides round: GCN's two layers 28 u = 0.11,
# GAT's 36 u = 0.14) and within (R + C) u of float64, which also sees the C
# inputs and parameters cast to bfloat16 (GCN 20 u, GAT 24 u). A
# cross-entropy moves by at most twice its logits' largest move (the
# label's logit, the log-sum-exp), and so does their mean, the loss; so
# does the link step's binary cross-entropy (log-sigmoid is 1-Lipschitz).
# A gradient carries the forward's error (the activations it multiplies)
# and the backward's own roundings, which a layer takes at most as often
# as its forward, and one more, the weight gradient's product: by norm
# within 2 (2R + 1) u of the CPU's bfloat16 path (GCN 58 u = 0.23, GAT 74
# u = 0.29) and (2R + C + 1) u of float64 (GCN 35 u = 0.14, GAT 43 u =
# 0.17). The other cells: GCN with learned edge weights adds the weighted
# degree a layer (R = 16) and the weights' cast (C = 7); GAT (b)'s dropout
# masks are exact (0 or 2.5); the link step is 3a's encoder and one
# rounded dot (R = 15), whose error follows max ||h_i||^2 (Cauchy-Schwarz:
# each score's sum of |h_i h_j| is below it), not max |score|; EdgeConv,
# per layer x_j - x_i, the product and + bias (R = 6; x, two weights, two
# biases: C = 5), its maxima exact; graph classification, per GraphConv
# two products, the SpMM, their sum and + bias, then the head's product and
# bias (R = 12; x and 8 parameters: C = 9). GATv2 (3f): per GATv2Conv the
# dense products W_i x and W_j x, the self logit's W_i x + W_j x and its
# einsum with a, the attention sum (num), its normalisation (out), + bias
# and the mean over heads, 8 (the edges' logits are computed in float32
# from the rounded projections on both sides, as K9 and the CPU path do:
# none), R = 16; x and per layer dense_i's weight and bias, dense_j's
# weight, a and the bias, C = 11. Its backward's dq is poorly conditioned:
# dq[r] = a * sum_e dlg_e lrelu'(raw_e), and a receiver's dlg_e = alpha_e
# (<k_e, dy> - s_n) sum to 0 (the softmax's Jacobian; the self-loop
# aside), so dq keeps only the part of lrelu' (1 or the slope 0.2, each
# about half the time: sd 0.4 about its mean 0.6) that does not average
# out, while an error of the dlg_e that does not sum to 0 keeps the whole
# mean. The logit path's gradients (dq, so dense_i's weight) take kappa =
# 0.6 / 0.4 = 1.5 times the count: BF16_KAPPA, on every gradient limit of
# the cell. The CPU tests hold dq per element against S, the same sum
# over absolute values (tests/test_torch_gatv2_bf16.py). Transformer (3g):
# per TransformerConv the four dense products W3 x (q), W4 x (k), W2 x (v)
# and W1 x (the root) and their + bias, 8, the attention sum (num) and its
# normalisation (out), 2, and the root's + h, 1: 11 (the logits are
# float32 from the rounded projections on both sides, as K6 and the CPU
# path compute them: none; the head layer's mean over one head is exact),
# R = 22; x and per layer four weights and four biases, C = 17. Its key
# bias (W4.bias) has a gradient of 0 in exact arithmetic (see
# ZERO_GRAD_FLOOR): each side's is the rounding of terms at the scale of
# the other gradients, so it is held to the largest gradient's norm, not
# its own. AGNN (3h): the input Linear's product and + bias, 2; per
# AGNNConv the sum of x^2 and its square root, x / norm, beta * x_n, the
# self logit's sum and its beta *, the attention sum (num) and its
# normalisation (out), 8; the head Linear's product and + bias, 2: R = 20;
# x, two weights, two biases and the two betas, C = 7. A beta's gradient
# sum_e dlg_e lg_e / beta cancels: a receiver's dlg_e sum to about 0 (the
# softmax's Jacobian), and after relu and an attention layer the rows x_n
# are nearly parallel, so the logits lg_e of a row nearly equal. Its
# rounding errors follow S, the same sum over absolute values, not the
# gradient, so each beta is held by S (agnn_beta_scales, from the float64
# side) in place of its norm. Neither cell takes a kappa: the
# Transformer's dq = sum_e dlg_e k_e keeps the part of k_e that varies over
# a row's edges, and the errors that do not sum to 0 (those of s_n) keep
# the row's mean of k_e = W4 x_s + b, about 1/sqrt(15) of that part (x has
# mean 0, b starts at 0); AGNN's cancelling sums are the betas', held by
# S.
BF16_U = 2.0 ** -8
# per cell: (R, C), see above
BF16_CELLS = {"GCN": (14, 6), "GAT": (18, 6), "GATv2": (16, 11),
              "GCN learned edge weights": (16, 7), "GAT (b)": (18, 6),
              "link prediction": (15, 6), "EdgeConv": (6, 5),
              "graph classification": (12, 9), "Transformer": (22, 17),
              "AGNN": (20, 7)}
# per cell: the factor kappa of its gradient limits where the backward
# cancels (GATv2's dq, see above); 1 for the others
BF16_KAPPA = {"GATv2": 1.5}


_T0 = time.perf_counter()
_HEADINGS = []   # (phase, seconds since the start) of each phase heading


def log(msg: str) -> None:
    """Print ``msg``; a phase's heading also gets the seconds since the
    script started, so the log shows where the run's time goes."""
    if msg.startswith("phase "):
        t = time.perf_counter() - _T0
        # "3o (3c)": 3o's card-vs-CPU steps apart from its training
        head = msg.split(":")[0][6:]
        _HEADINGS.append((head if head.endswith("(3c)")
                          else head.split(" (")[0], t))
        msg += f"  [{t:.1f} s]"
    print(msg, flush=True)


def log_phase_seconds() -> dict:
    """The seconds each phase took, from its headings to the next heading
    (the last to now), summed over its headings; logged and returned."""
    now = time.perf_counter() - _T0
    spans = {}
    for (name, t), (_, t_next) in zip(_HEADINGS,
                                      _HEADINGS[1:] + [("", now)]):
        spans[name] = spans.get(name, 0.0) + t_next - t
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in spans.items()))
    return spans


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log_ptxas(name: str, text: str) -> None:
    """The ``-Xptxas=-v`` report of library ``name``'s build: its number of
    kernel instances and the most registers one uses, and each instance
    that spills, by its mangled name."""
    fn, count, regs, spills = None, 0, 0, []
    for line in text.splitlines():
        if "Function properties for" in line:
            fn, count = line.split("Function properties for", 1)[1].strip(), \
                count + 1
        elif "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            if any(nums[1:]):
                spills.append(f"{fn}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            regs = max(regs, int(line.split("Used", 1)[1].split()[0]))
    log(f"  ptxas {name}: {count} functions, at most {regs} registers, "
        f"{len(spills)} spill")
    for item in spills:
        log(f"    spills: {item}")


# the row vectors of a kernel instance in its mangled name (vec.cuh)
_MANGLED_VECTORS = {"5uint4": "bf16x8", "5uint2": "bf16x4", "t": "bf16x1",
                    "6float4": "float4", "f": "float"}


def log_dot_bf16_ptxas(text: str) -> list:
    """Each bfloat16 instance of K6 (rows, strips), K7 (rows, strips) and
    K8 (register and staged) in ``edge_softmax``'s
    ``-Xptxas=-v`` report, or of K2 (per head, all heads) in ``spmm``'s:
    its kernel, vector, template integers, registers and spill bytes
    (stores, loads), logged and returned."""
    pat = re.compile(r"((?:dot_(?:softmax|bwd_rev|bwd_dq|strip_\w+?)"
                     r"(?:_rows|_staged)?|spmm_sddmm_(?:csr|heads))"
                     r"_kernel)I(Li\d+E)?(5uint4|5uint2|t|6float4|f)"
                     r"((?:Li\d+E)*)E")
    rows, fn = [], None
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = pat.search(line)
            spill = None
        elif fn is not None and "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1:3]
        elif fn is not None and "Used" in line and "registers" in line:
            vec = _MANGLED_VECTORS[fn.group(3)]
            if vec.startswith("bf16") and (fn.group(2) in (None, "Li6E")):
                ints = [int(x) for x in re.findall(r"\d+", fn.group(4))]
                rows.append({"kernel": fn.group(1), "vector": vec,
                             "template": ints, "registers": int(
                                 line.split("Used", 1)[1].split()[0]),
                             "spill_bytes": spill})
                log(f"  ptxas bf16 {fn.group(1)}<{vec}, "
                    f"{', '.join(map(str, ints))}>: {rows[-1]['registers']} "
                    f"registers, spill stores/loads {spill}")
            fn = None
    return rows


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


def device_rows(prof, steps: int = 1) -> list:
    """``(ms, launches, name)`` per device kernel of a profiler run of
    ``steps`` like steps, largest first: its launches per step (its records
    over ``steps``, rounded, at least 1) and its mean time times those, so
    that a record the profiler loses does not shrink a step's time."""
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "is_user_annotation", False):
            continue   # ranges, not kernels: their time is their kernels'
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            per = max(1, round(ev.count / steps))
            rows.append((dev_us / 1e3 / ev.count * per, per, ev.key))
    return sorted(rows, reverse=True)


DEVICE_RECORDS = []   # per device_ms call: kernels seen, calls made


def device_ms(fn, calls: int = 20, retries: int = 5,
              required: bool = True) -> float | None:
    """The card's own time per call: every kernel that ``calls`` calls
    launch, by ``torch.profiler`` (CUPTI's start and end of each kernel), so
    that the host's time between launches is not counted. Per kernel name,
    its mean time times its launches per call (its records over ``calls``,
    rounded, at least 1): a record the profiler loses does not shrink the
    sum. Each call's counts and per-kernel times go to
    ``DEVICE_RECORDS``. When the profiler returns no kernel record (now
    and then, more often late in a full run), it measures again over twice
    the calls; after ``retries`` such runs it raises, or, where not
    ``required``, returns None (not measured)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        if retries:   # the profiler now and then returns no kernel records
            log("  (the profiler saw no device time: measuring again)")
            return device_ms(fn, 2 * calls, retries - 1, required)
        if not required:
            log("  (the profiler saw no device time: not measured)")
            return None
        raise AssertionError("the profiler saw no device time")
    DEVICE_RECORDS.append({"calls": calls, "records": {
        name[:60]: n for _, n, name in rows}, "ms_per_call": {
        name[:60]: ms / calls for ms, _, name in rows}})
    return sum(ms / n * max(1, round(n / calls)) for ms, n, _ in rows)


# more than twice the H100's 50 MB L2: a write of this many bytes leaves
# nothing of an earlier call's inputs there
L2_FLUSH_BYTES = 128 << 20


def cold_device_ms(fn, pats, calls: int = 20, retries: int = 3) -> float:
    """The device time per call of the kernels of ``fn`` whose names hold
    one of ``pats``, when every call follows a write of
    :data:`L2_FLUSH_BYTES`: what the kernel takes when its inputs come from
    HBM, as in a step whose other work has evicted them (back-to-back calls
    on inputs smaller than L2 find them there). The flush's own kernel is
    not counted. As in :func:`device_ms`, each kernel's mean time counts
    once per launch a call makes, so a record the profiler loses does not
    shrink the sum."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            buf.zero_()
            fn()
        torch.cuda.synchronize()
    ms = sum(m / n * max(1, round(n / calls))
             for m, n, key in device_rows(prof)
             if any(p in key for p in pats))
    if ms == 0:
        if retries:   # the profiler now and then returns no kernel records
            return cold_device_ms(fn, pats, calls, retries - 1)
        raise AssertionError("the profiler saw no device time")
    return ms


def launch_ms(prof, pats, steps: int) -> list:
    """Per launch of the kernels whose names hold one of ``pats``, in launch
    order within a step, its device time in ms: the median over ``steps``
    profiled steps of the launch at that position ([] when the profiler
    kept no such record or the launches do not split evenly by step; a
    caller checks the length against the launches it expects, since a
    lost record shifts the positions)."""
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and any(p in e.name for p in pats)),
                 key=lambda e: e.time_range.start)
    if not evs or len(evs) % steps:
        return []
    per = len(evs) // steps
    return [statistics.median(evs[s * per + i].time_range.elapsed_us() / 1e3
                              for s in range(steps)) for i in range(per)]


def host_us(fn, *, batches: int = 10, calls: int = 100) -> float:
    """The host's time per call, in µs: the least over ``batches`` of
    ``calls`` back-to-back calls on the host clock with no synchronise among
    them (what the wrapper costs the host, the launch included). The least,
    not the median: the host's cores are shared, and other work only ever
    adds to a batch's time (medians moved 2x between runs on one card)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(times)


def timings(fn, plain=None, lib=None, device_required=True) -> dict:
    """A kernel wrapper's times: ``ms`` (CUDA events over back-to-back
    calls, host gaps included), ``device_ms`` (the profiler's kernel time;
    None where the profiler saw none and not ``device_required``),
    ``host_us`` (:func:`host_us`); the plain version's CUDA-event time and
    the library call's CUDA-event and device times where given."""
    out = {"ms": cuda_ms(fn),
           "device_ms": device_ms(fn, required=device_required),
           "host_us": host_us(fn), "plain_ms": None, "library_ms": None,
           "library_device_ms": None}
    if plain is not None:
        out["plain_ms"] = cuda_ms(plain, warmup=1, batches=3, per_batch=2)
    if lib is not None:
        out["library_ms"] = cuda_ms(lib)
        out["library_device_ms"] = device_ms(lib, required=device_required)
    return out


def fmt_ms(v) -> str:
    return "none" if v is None else f"{v:.4f} ms"


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, *,
            rtol: float = RTOL, atol: float = ATOL,
            quiet: bool = False) -> float:
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
    if not quiet or not ok:
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

def kernel_case(res, card, key, label, fn, plain, args, byt, flops,
                regathered, checks=None, lib=None):
    """Hold ``fn(*args)`` to ``plain(*args)``, time both (and ``lib()``,
    one PyTorch call computing the same function, if given) and add the
    case to ``res[key]``; returns the plain outputs. ``byt`` is the
    compulsory bytes, ``regathered`` what the per-edge gathers read again
    when L2 keeps nothing. ``checks``: per output, its name, tolerance and
    a reference to hold it to in place of the plain output (or None); by
    default ``out0``, ``out1``, ... at RTOL / ATOL against the plain
    ones."""
    got, want = fn(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    checks = checks or [(f"out{i}", {}, None) for i in range(len(want))]
    err = max(compare(f"{key.upper()} {label} {name}", a,
                      b if ref is None else ref, **tol)
              for (name, tol, ref), a, b in zip(checks, got, want))
    res[key]["err"] = max(res[key]["err"], err)
    b_ms, b_by = bound(byt, flops, card)
    res[key]["variants"].append({
        "case": label, **timings(lambda: fn(*args), lambda: plain(*args),
                                 lib),
        "bound_ms": b_ms, "bound_by": b_by,
        "no_reuse_bound_ms": (byt + regathered) / peaks(card)[0] * 1e3,
        "max_abs_err": err})
    return want


def log_times(res, width: int) -> None:
    for key, r in res.items():
        for v in r["variants"]:
            log(f"  time {key.upper():<3} {v['case']:<{width}} "
                f"kernel={v['ms']:.4f} ms device={fmt_ms(v['device_ms'])} "
                f"host={v['host_us']:.1f} us plain={fmt_ms(v['plain_ms'])} "
                f"library={fmt_ms(v['library_ms'])} (device "
                f"{fmt_ms(v['library_device_ms'])})"
                + (f" L2-flushed device={v['cold_device_ms']:.4f} ms"
                   if "cold_device_ms" in v else "") + " bound="
                f"{v['bound_ms']:.4f} ms ({v['bound_by']}) no-reuse bound="
                f"{v['no_reuse_bound_ms']:.4f} ms")


def k1_source_rows(col, eid, w_, n_src: int) -> int:
    """The rows of K1's source table that its function reads: those that an
    edge of nonzero weight references (``w[eid[k]]``; every edge when
    unweighted), or every row when ``col`` is None."""
    if col is None:
        return n_src
    if w_ is not None:
        we = w_ if eid is None else w_.index_select(0, eid.long())
        col = col[we != 0]
    return int(torch.unique(col).numel())


def k1_timed_case(res, card, label, paths, args, lib) -> None:
    """Hold K1 (``spmm_csr`` on ``args``) to its plain version and to
    ``lib()``, one PyTorch call computing the same function, at RTOL /
    ATOL; time all three and add the case to ``res["k1"]``, with K1's
    device time when each call follows an L2 flush (:func:`cold_device_ms`).
    Compulsory bytes: indptr, col, eid (read only with w), w, the output
    and the source rows that the function reads (:func:`k1_source_rows`)
    once each; with no reuse every edge reads a whole row."""
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    indptr, col, eid, w_, src = args
    n_rows, d = indptr.numel() - 1, src.shape[1]
    n_edges = col.numel() if col is not None else src.shape[0]
    y = S.spmm_csr(*args)
    err = compare(f"K1 {label}", y, S.spmm_plain(*args))
    res["k1"]["err"] = max(res["k1"]["err"], err)
    read = (col, w_) + ((eid,) if w_ is not None else ())
    idx = 4 * ((n_rows + 1) + sum(n_edges for t in read if t is not None))
    src_rows = k1_source_rows(col, eid, w_, src.shape[0])
    byt = idx + 4 * (src_rows + n_rows) * d
    no_reuse = idx + 4 * (n_edges + n_rows) * d if col is not None else byt
    b_ms, b_by = bound(byt, (1 if w_ is None else 2) * n_edges * d, card)
    compare(f"K1 {label} vs library", y, lib())
    res["k1"]["variants"].append({
        "case": label, "paths": paths, "d": d, "source_rows": src_rows,
        **timings(lambda: S.spmm_csr(*args), lambda: S.spmm_plain(*args),
                  lib),
        "cold_device_ms": cold_device_ms(lambda: S.spmm_csr(*args),
                                         STEP_KERNELS["k1"]),
        "bound_ms": b_ms, "bound_by": b_by,
        "no_reuse_bound_ms": no_reuse / peaks(card)[0] * 1e3,
        "max_abs_err": err})
    log(f"  K1 {label}: launched by {paths}; reads {src_rows} of "
        f"{src.shape[0]} source rows")


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
    # GAT (b)'s backward runs K2 once for its H=4 heads of D=32 with w =
    # mask * alpha: attention weights, about 60% of them dropped to 0 (the
    # first port ran it once per head, the D=32 case)
    x32 = torch.randn(N, D // GAT_HEADS, generator=gen, device=dev)
    dy32 = torch.randn(N, D // GAT_HEADS, generator=gen, device=dev)
    w_alpha = (torch.rand(E, generator=gen, device=dev) / 8
               * ((torch.rand(E, generator=gen, device=dev) < 0.4) / 0.4))
    w_alpha4 = (torch.rand(E, GAT_HEADS, generator=gen, device=dev) / 8
                * ((torch.rand(E, GAT_HEADS, generator=gen, device=dev)
                    < 0.4) / 0.4))
    ir, cr = g.indptr_r, g.col_r
    is_, cs, es = g.indptr_s, g.col_s, g.eid_s
    res = {"k1": {"err": 0.0, "variants": []}, "k2": {"err": 0.0,
                                                      "variants": []}}
    bw = peaks(card)[0]

    def k1_case(label, paths, args, lib):
        k1_timed_case(res, card, label, paths, args, lib)

    # the library yardsticks: torch.sparse.mm over CSR tensors of the
    # receiver grouping and of the sender grouping (values w[eid] in
    # sender order), and segment_reduce for rows already in CSR order
    def csr(indptr, col, vals, cols=N):
        return torch.sparse_csr_tensor(indptr, col, vals, (N, cols))

    a_ones = csr(ir, cr, torch.ones(E, device=dev))
    a_w = csr(ir, cr, w)
    s_ones = csr(is_, cs, torch.ones(E, device=dev))
    s_w = csr(is_, cs, w.index_select(0, es.long()))
    log("phase 2: kernels vs plain versions "
        f"(N={N}, E={E}, D={D}, float32)")
    # which phase-3 path launches each case, per train step
    k1_case("fwd receiver-CSR D=128",
            "GCN layer 1 fwd (3a, 1/step); link encoder fwd (3i, 2/step)",
            (ir, cr, None, None, x), lambda: torch.sparse.mm(a_ones, x))
    k1_case("fwd receiver-CSR weighted D=128",
            "DotDecoder bwd dxi (3i, 2/step)", (ir, cr, None, w, x),
            lambda: torch.sparse.mm(a_w, x))
    k1_case("bwd sender-CSR D=128", "link encoder layer 2 bwd (3i, 1/step)",
            (is_, cs, es, None, dy), lambda: torch.sparse.mm(s_ones, dy))
    k1_case("bwd sender-CSR weighted D=128",
            "DotDecoder bwd dxj (3i, 2/step)", (is_, cs, es, w, dy),
            lambda: torch.sparse.mm(s_w, dy))
    k1_case("fwd receiver-CSR D=8", "GCN layer 2 fwd (3a, 1/step)",
            (ir, cr, None, None, x8), lambda: torch.sparse.mm(a_ones, x8))
    k1_case("bwd sender-CSR D=8", "GCN layer 2 bwd (3a, 1/step)",
            (is_, cs, es, None, dy8), lambda: torch.sparse.mm(s_ones, dy8))
    k1_case("gather-bwd edge rows D=8",
            "none of phase 3 (fast_gather's backward at a narrow width)",
            (ir, None, None, None, e8),
            lambda: torch.segment_reduce(e8, "sum", offsets=ir))
    k1_case("fwd receiver-CSR D=7 (scalar path)",
            "graph classification layer 1 fwd (3k, 1/step, on its batch)",
            (ir, cr, None, w, x7), lambda: torch.sparse.mm(a_w, x7))
    # EdgeConv layer 2's endpoint gathers: the backward of x[receivers]
    # sums [E, 128] rows already in receiver order; that of x[senders]
    # gathers them by edge id in sender order
    e128 = torch.randn(E, D, generator=gen, device=dev)
    k1_case("gather-bwd edge rows D=128", "EdgeConv layer 2 bwd x_i "
            "(3j, 1/step); EGNNConv layer 2 bwd h_i (3v, 1/step)",
            (ir, None, None, None, e128),
            lambda: torch.segment_reduce(e128, "sum", offsets=ir))
    s_eid = csr(is_, es, torch.ones(E, device=dev), cols=E)
    k1_case("gather-bwd edge rows by eid D=128",
            "EdgeConv layer 2 bwd x_j (3j, 1/step); EGNNConv layer 2 bwd h_j "
            "(3v, 1/step)",
            (is_, es, None, None, e128), lambda: torch.sparse.mm(s_eid, e128))
    del e128
    # 3v's endpoint gathers at their own widths, each by receiver and by
    # sender (edge ids over the sender CSR): CGConv's 64, GMMConv's [N, K*O]
    # projections 48 and 24, MEGNetConv's 32 and EGNNConv's positions 3 (the
    # scalar path); a generator of their own leaves the other cases' inputs
    gen_v = torch.Generator(device=dev).manual_seed(22)
    for d, at_r, at_s in (
            (64, "CGConv bwd x_i (3v, 2/step)", "CGConv bwd x_j (3v, 2/step)"),
            (48, None, "GMMConv layer 1 bwd dense_x(x)[s] (3v, 1/step)"),
            (32, "MEGNetConv bwd x_i (3v, 2/step)",
             "MEGNetConv bwd x_j (3v, 2/step)"),
            (24, None, "GMMConv layer 2 bwd dense_x(h)[s] (3v, 1/step)"),
            (3, "EGNNConv layer 2 bwd pos_i (3v, 1/step)",
             "EGNNConv layer 2 bwd pos_j (3v, 1/step)")):
        ed = torch.randn(E, d, generator=gen_v, device=dev)
        k1_case(f"gather-bwd edge rows D={d}",
                at_r or "none of phase 3 (3v gathers this width by sender)",
                (ir, None, None, None, ed),
                lambda: torch.segment_reduce(ed, "sum", offsets=ir))
        k1_case(f"gather-bwd edge rows by eid D={d}", at_s,
                (is_, es, None, None, ed), lambda: torch.sparse.mm(s_eid, ed))
    # NNConv's x_j on its own graph (3v cuts it to NNCONV_E edges)
    gn = gnn.rand_graph(N, NNCONV_E, seed=3, device=dev)
    ed = torch.randn(NNCONV_E, 64, generator=gen_v, device=dev)
    sn_eid = csr(gn.indptr_s, gn.eid_s, torch.ones(NNCONV_E, device=dev),
                 cols=NNCONV_E)
    k1_case(f"gather-bwd edge rows by eid D=64 on rand_graph(N, {NNCONV_E})",
            "NNConv bwd x_j (3v, 2/step)",
            (gn.indptr_s, gn.eid_s, None, None, ed),
            lambda: torch.sparse.mm(sn_eid, ed))
    del ed, s_eid, gn, sn_eid
    # ChebConv's power iteration: one [N, 1] column (one graph)
    x1 = torch.randn(N, 1, generator=gen, device=dev)
    k1_case("fwd receiver-CSR D=1",
            f"default ChebConv's power iteration (3l, {CHEB_POWER_K1}/step)",
            (ir, cr, None, None, x1), lambda: torch.sparse.mm(a_ones, x1))
    # g.reverse()'s receiver CSR is g's sender CSR, its positions mapped to
    # edge ids by eid_r (the weights stay in edge order)
    gr = g.reverse()
    k1_case("fwd reversed-graph receiver-CSR D=128",
            "DConv over g.reverse() fwd (3l, 2/step; on the reverse, 2)",
            (gr.indptr_r, gr.col_r, gr.eid_r, None, x),
            lambda: torch.sparse.mm(s_ones, x))
    k1_case("fwd reversed-graph receiver-CSR weighted by eid_r D=128",
            "DConv on the weighted graph's reverse (3c, 2 fwd)",
            (gr.indptr_r, gr.col_r, gr.eid_r, w, x),
            lambda: torch.sparse.mm(s_w, x))
    del x1, gr

    heads_d = (N, GAT_HEADS, D // GAT_HEADS)
    for label, xx, dd, ww in (
            (f"D={D}", x, dy, w), (f"D={D // GAT_HEADS}", x32, dy32, w_alpha),
            (f"H={GAT_HEADS} D={D // GAT_HEADS} one launch",
             x.view(heads_d), dy.view(heads_d), w_alpha4),
            (f"D={OUT_D}", x8, dy8, w)):
        args = (is_, cs, es, ww, dd, xx)
        dx, dw = S.spmm_sddmm(*args)
        rdx, rdw = S.spmm_sddmm_plain(*args)
        err = max(compare(f"K2 dx {label}", dx, rdx),
                  compare(f"K2 dw {label}", dw, rdw))
        res["k2"]["err"] = max(res["k2"]["err"], err)
        h, d = ww.numel() // E, xx.shape[-1]
        # dy, x and dx rows; indptr, col and eid entries; w and dw per
        # edge and head
        byt = 4 * (3 * N * h * d + (N + 1) + 2 * E + 2 * E * h)
        b_ms, b_by = bound(byt, 4 * E * h * d, card)
        res["k2"]["variants"].append({
            "case": f"bwd sender-CSR {label}", "d": d, "heads": h,
            **timings(lambda: S.spmm_sddmm(*args),
                      lambda: S.spmm_sddmm_plain(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": (byt + 4 * (E - N) * h * d) / bw * 1e3,
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

    log_times(res, 34)
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return res


def compare_bf16(name: str, got: torch.Tensor, ref: torch.Tensor, *,
                 quiet: bool = False, extra=None) -> float:
    """Hold a bfloat16 output to its plain version within one bfloat16 ulp
    of ``|ref|`` plus ATOL (see BF16_U), plus ``extra`` per element where
    given (:func:`dot_kink_allowance`); a float32 one (the softmax state)
    by :func:`compare`."""
    if ref.dtype != torch.bfloat16:
        return compare(name, got, ref, quiet=quiet)
    if got.dtype != torch.bfloat16 or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    a, b = got.detach().double(), ref.detach().double()
    # 2^(e - 8) for |b| in [2^(e-1), 2^e): frexp's exponent is exact, where
    # the card's log2 of a power of two may land below the integer
    _, e = torch.frexp(b.abs().clamp(min=torch.finfo(torch.float32).tiny))
    ulp = torch.exp2(e.double() - 8)
    if extra is not None:
        ulp = ulp + extra
    diff = (a - b).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    worst = float((diff / (ulp + ATOL)).max()) if diff.numel() else 0.0
    ok = worst <= 1.0
    if not quiet or not ok:
        log(f"  {name:<38} max_abs_err={err:.3e} |err|/(ulp+atol) at most "
            f"{worst:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    return err


def bf16_phase(g, gb, card: str) -> dict:
    """2h: the bfloat16 kernels against their plain versions on the card:
    K1 over the receiver CSR at D=128 (bench.py's ``large_pallas_bf16``,
    :142-147) and 8, over the sender CSR at D=128 and 8 (3o's GCN launches
    the D=8 ones and the receiver D=128) and weighted at D=128 (3o's
    ``DotDecoder`` backward), over ``[E, D]`` edge rows at D=128 and 8 and
    by edge id over the sender CSR at D=128 (the endpoint gathers'
    backward: 3o's EdgeConv); K3, K4
    and K5 at (H, D) = (4, 32) and (1, 8) (3o's GAT) and (1, 128)
    (bench.py's ``attention_bf16``, :235-250); K9, K10 (``dq``; its
    float32 ``da`` held to the plain version in float64, as 2c holds it)
    and K11 at (H, O) = (4, 32) and (1, 8) (3o's GATv2); K6 (writing the
    raw logits), K7 (from them) and K8 at 2d's (H, O, D) = (4, 32, 32),
    (1, 8, 8), (1, 128, 128), whose K6 and K7 take rows (asserted), and
    (4, 32, 32) with a slope (3o's Transformer and AGNN), and at
    (1, 264, 264) (K6 and K7 in strips, asserted; K8 in two register
    chunks); K2 over the
    sender CSR at D=128 (one whole-row strip) and 8 (3o's GCN with learned
    edge weights), at H=4, D=32 in one launch (3o's GAT (b) layer 1: the
    all-heads walk) and at H=4, D=128 (by sender-CSR position over several
    strips), each layout asserted; K12 at (4, 32) with
    node values,
    with them and the dropout mask, with edge values and the mask, and at
    (1, 8) with node values and the mask (3o's GAT (b)); K13 at D=128 (3o's
    link step), 32 and (4, 32); K14 (max and min) and its backward over the
    receiver CSR at F=128, 8 and 4 (3o's EdgeConv) and over the 3k batch's
    graph CSR at F=64 (3o's graph classification), held bit for bit on
    values on a grid of 1/4 (ties) with a NaN entry and rows emptied, as
    2f holds the float32 ones. The other kernels are held within one
    bfloat16 ulp of the plain version (``compare_bf16``). Each row has the
    bfloat16 kernel's times, the float32 kernel's device time on the same
    values widened (``f32_device_ms``, this call), the bound at 2 bytes a
    bfloat16 element (4 an index or a float32 state entry) and, where one
    PyTorch call computes the same function in bfloat16
    (``torch.sparse.mm`` for K1, ``torch.sparse.sampled_addmm`` for K13,
    ``torch.segment_reduce`` for K14), its times or the error it raised
    (``library_error``)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES
    from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD
    from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    ir, cr, is_, cs, es = g.indptr_r, g.col_r, g.indptr_s, g.col_s, g.eid_s
    res = {k: {"err": 0.0, "variants": []}
           for k in ("k1_bf16", "k2_bf16", "k3_bf16", "k4_bf16", "k5_bf16",
                     "k6_bf16", "k7_bf16", "k8_bf16", "k9_bf16", "k10_bf16",
                     "k11_bf16", "k12_bf16", "k13_bf16", "k14_bf16",
                     "k14_bwd_bf16")}
    log(f"phase 2h: bfloat16 kernels vs plain versions (N={N}, E={E})")

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def case(key, label, fn, plain, args, byt, flops, lib=None,
             exact=False, again=0, layout=None):
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if exact:
            for i, (a, b) in enumerate(zip(got, want)):
                same_bits(f"{key.upper()} {label} out{i}", a, b)
            err = 0.0
        else:
            err = max(compare_bf16(f"{key.upper()} {label} out{i}", a, b)
                      for i, (a, b) in enumerate(zip(got, want)))
        res[key]["err"] = max(res[key]["err"], err)
        wide = tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype == bf else t for t in args)
        lib_error = None
        if lib is not None:
            try:   # a yardstick only: where it cannot run, say why
                lib_err = float((lib().double() - want[0].double()).abs()
                                .max())
                log(f"  {key.upper()} {label} library max_abs_err="
                    f"{lib_err:.3e} (logged, not held)")
            except RuntimeError as exc:
                lib_error, lib = str(exc).splitlines()[0], None
                log(f"  {key.upper()} {label} library: {lib_error}")
        b_ms, b_by = bound(byt, flops, card)
        res[key]["variants"].append({
            "case": label, **timings(lambda: fn(*args), lambda: plain(*args),
                                     lib),
            "f32_device_ms": device_ms(lambda: fn(*wide)),
            "library_error": lib_error, "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": (byt + again) / peaks(card)[0] * 1e3,
            "max_abs_err": err,
            **({} if layout is None else {"layout": list(layout)})})
        return want

    def csr(indptr, col, vals=None, cols=N):
        vals = torch.ones(E, dtype=bf, device=dev) if vals is None else vals
        return torch.sparse_csr_tensor(indptr, col, vals, (N, cols))

    # K1: the library's matrix is the CSR with the weights in its order
    # (w[eid] over the sender CSR); the endpoint gathers' backward sums
    # [E, D] edge rows in receiver order (col None: the rows in order) or
    # by edge id over the sender CSR (3j's x_j)
    w = rn(E)
    a_r, a_s = csr(ir, cr), csr(is_, cs)
    a_sw = csr(is_, cs, w.index_select(0, es.long()))
    a_e = csr(ir, torch.arange(E, dtype=torch.int32, device=dev), cols=E)
    a_eid = csr(is_, es, cols=E)
    for label, args, a in (
            (f"fwd receiver-CSR D={D}", (ir, cr, None, None, rn(N, D)), a_r),
            (f"fwd receiver-CSR D={OUT_D}", (ir, cr, None, None,
                                             rn(N, OUT_D)), a_r),
            (f"bwd sender-CSR D={D}", (is_, cs, es, None, rn(N, D)), a_s),
            (f"bwd sender-CSR D={OUT_D}", (is_, cs, es, None,
                                           rn(N, OUT_D)), a_s),
            (f"bwd sender-CSR weighted D={D}", (is_, cs, es, w, rn(N, D)),
             a_sw),
            (f"gather-bwd edge rows D={D}", (ir, None, None, None,
                                             rn(E, D)), a_e),
            (f"gather-bwd edge rows D={OUT_D}", (ir, None, None, None,
                                                 rn(E, OUT_D)), a_e),
            (f"gather-bwd edge rows by eid D={D}", (is_, es, None, None,
                                                    rn(E, D)), a_eid)):
        indptr, col, eid, w_, x = args
        rows, d = indptr.numel() - 1, x.shape[1]
        # indptr and col (int32, col None: none), eid where w is read
        # through it, w in bfloat16; the source rows the function reads
        # and the output
        idx = (4 * (rows + 1 + E * (col is not None)
                    + E * (eid is not None and w_ is not None))
               + 2 * E * (w_ is not None))
        src = k1_source_rows(col, eid, w_, x.shape[0])
        # with no L2 reuse a gathered source row is read once an edge
        case("k1_bf16", label, S.spmm_csr, S.spmm_plain, args,
             idx + 2 * (src + rows) * d, (1 + (w_ is not None)) * E * d,
             lambda a=a, x=x: torch.sparse.mm(a, x),
             again=2 * (E - src) * d if col is not None else 0)
    del a_r, a_s, a_sw, a_e, a_eid

    # K2 over the sender CSR: int32 CSR and eid, bfloat16 w, dy, x, dx, dw;
    # one case on each path of bfloat16's chooser (asserted): D=128 one
    # whole-row strip, D=8 one head by edge id, (4, 32) the all-heads walk,
    # (4, 128) by sender-CSR position over several strips
    for h, d, mode, one_strip in ((1, D, 0, True), (1, OUT_D, 0, True),
                                  (GAT_HEADS, D // GAT_HEADS, 2, True),
                                  (GAT_HEADS, D, 1, False)):
        rows = (N, d) if h == 1 else (N, h, d)
        w = rn(*((E,) if h == 1 else (E, h)))
        args = (is_, cs, es, w, rn(*rows), rn(*rows))
        S.spmm_sddmm(*args)   # the layout the wrapper chose and launched
        lay, strips = S.last_layout["k2_bf16"]
        log(f"  K2 bf16 H={h} D={d}: layout {lay} "
            "(log2 rows, log2 strip, unroll, cap, mode: 0 by edge id, 1 by "
            f"position, 2 all heads), {strips} strip(s)")
        if lay[4] != mode or (strips == 1) != one_strip:
            raise AssertionError(
                f"K2 bf16 at H={h} D={d} must take mode {mode} in "
                f"{'one' if one_strip else 'several'} strip(s), got {lay}")
        case("k2_bf16", f"bwd sender-CSR H={h} D={d}", S.spmm_sddmm,
             S.spmm_sddmm_plain, args,
             4 * (N + 1 + 2 * E) + 2 * 2 * E * h + 3 * 2 * N * h * d,
             4 * E * h * d, again=2 * (E - N) * h * d, layout=lay)
        del w, args

    # K12: int32 CSR, bfloat16 logits and mask ([E, H]) and values, the
    # float32 state
    for h, d, mask, node in ((GAT_HEADS, D // GAT_HEADS, False, True),
                             (GAT_HEADS, D // GAT_HEADS, True, True),
                             (GAT_HEADS, D // GAT_HEADS, True, False),
                             (1, OUT_D, True, True)):
        keep = (torch.rand(E, h, generator=gen, device=dev) < 0.4).to(bf)
        args = (ir, cr if node else None, rn(E, h), keep * 2.5 if mask
                else None, rn(N if node else E, h, d))
        label = (f"{'node' if node else 'edge'} values"
                 f"{' + dropout mask' if mask else ''} H={h} D={d}")
        case("k12_bf16", label, ES.edge_softmax, ES.edge_softmax_plain,
             args, 4 * (N + 1 + E * node) + 2 * E * h * (1 + mask)
             + 2 * (N if node else E) * h * d + 2 * N * h * d + 8 * N * h,
             E * h * (2 * d + 6), again=2 * (E - N) * h * d * node)

    # K13: int32 CSR, bfloat16 xi, xj and out
    for h, d in ((1, D), (1, 32), (GAT_HEADS, D // GAT_HEADS)):
        xi, xj = rn(N, h, d), rn(N, h, d)
        if h == 1:
            pattern = torch.sparse_csr_tensor(
                ir, cr, torch.ones(E, dtype=bf, device=dev), (N, N))
            a, b = xi[:, 0], xj[:, 0].t()
        else:
            pattern = torch.sparse_csr_tensor(
                ir.expand(h, -1).contiguous(), cr.expand(h, -1).contiguous(),
                torch.ones(h, E, dtype=bf, device=dev), (h, N, N))
            a, b = xi.transpose(0, 1).contiguous(), xj.permute(1, 2, 0)
        case("k13_bf16", f"H={h} D={d}", SD.sddmm_csr, SD.sddmm_plain,
             (ir, cr, xi, xj), 4 * (N + 1 + E) + 2 * 2 * N * h * d
             + 2 * E * h, 2 * E * h * d, again=2 * (E - N) * h * d,
             lib=lambda p=pattern, a=a, b=b, h=h: torch.sparse.sampled_addmm(
                 p, a, b, beta=0.0).values().reshape(h, E).t())
        del xi, xj, pattern, a, b

    # K14 and its backward: bit for bit on a grid of 1/4 with a NaN and
    # rows emptied (2f's checks), then timed over the CSR as it is
    for label, ip, f, every in (
            (f"receiver CSR F={D}", ir, D, 1024),
            (f"receiver CSR F={OUT_D}", ir, OUT_D, 1024),
            (f"receiver CSR F={GAT_HEADS}", ir, GAT_HEADS, 1024),
            (f"graph CSR of the 3k batch F={TUD_HIDDEN}", gb.indptr_g,
             TUD_HIDDEN, 64)):
        n_rows, rows = ip.numel() - 1, int(ip[-1])
        data = (torch.round(torch.randn(rows, f, generator=gen, device=dev)
                            * 4) / 4).to(bf)
        dy = rn(n_rows, f)
        checked = data.clone()
        checked[rows // 3, f // 2] = float("nan")
        holes, _ = _empty_rows(ip, every)
        for op, kern, plain in (("max", SG.segment_max_csr,
                                 SG.segment_max_plain),
                                ("min", SG.segment_min_csr,
                                 SG.segment_min_plain)):
            same_bits(f"K14 bf16 {op} {label} (NaN, empty rows)",
                      kern(holes, checked), plain(holes, checked))
        out = SG.segment_max_plain(holes, checked)
        same_bits(f"K14 bf16 backward {label} (NaN, empty rows)",
                  SG.segment_max_bwd_csr(holes, checked, out, dy),
                  SG.segment_max_bwd_plain(holes, checked, out, dy))
        case("k14_bf16", label, SG.segment_max_csr, SG.segment_max_plain,
             (ip, data), 4 * (n_rows + 1) + 2 * (rows + n_rows) * f,
             rows * f, lambda ip=ip, data=data: torch.segment_reduce(
                 data, "max", offsets=ip), exact=True)
        out = SG.segment_max_csr(ip, data)
        case("k14_bwd_bf16", label, SG.segment_max_bwd_csr,
             SG.segment_max_bwd_plain, (ip, data, out, dy),
             4 * (n_rows + 1) + 2 * (2 * rows + 2 * n_rows) * f,
             2 * rows * f, exact=True, again=2 * rows * f)
        del data, dy, checked, out

    for h, d in ((GAT_HEADS, D // GAT_HEADS), (1, OUT_D), (1, D)):
        pi, pj, v, dy, sl, sv = (rn(N, h), rn(N, h), rn(N, h, d),
                                 rn(N, h, d), rn(N, h), rn(N, h, d))
        hd = f"H={h} D={d}"
        # int32 indptr and col; bfloat16 per-node scalars (2 N H bytes
        # each) and rows (2 N H D); float32 state (4 N H)
        idx, s2, s4, rows = 4 * (N + 1 + E), 2 * N * h, 4 * N * h, \
            2 * N * h * d
        # with no L2 reuse: a gathered row (2 bytes a value) and each
        # gathered scalar (pj 2 bytes; K5's pi 2, mx, den, s_n 4) an edge
        again, eh = 2 * (E - N) * h * d, (E - N) * h
        num, m, s_ = case("k3_bf16", hd, ES.gat_softmax, ES.gat_softmax_plain,
                          (ir, cr, pi, pj, v, 0.2),
                          idx + 2 * s2 + rows + rows + 2 * s4,
                          E * h * (2 * d + 6), again=again + 2 * eh)
        out, mx, den = ES.finalize_softmax(num, m, s_, sl, sv)
        s_n = (out.float() * dy.float()).sum(-1)
        bwd = (pi, pj, v, mx, den, s_n, dy, 0.2)
        case("k4_bf16", hd, ES.gat_bwd_dpi, ES.gat_bwd_dpi_plain,
             (ir, cr) + bwd, idx + 2 * s2 + 3 * s4 + 2 * rows + s2,
             E * h * (2 * d + 10), again=again + 2 * eh)
        case("k5_bf16", hd, ES.gat_bwd_rev, ES.gat_bwd_rev_plain,
             (is_, cs) + bwd, idx + 2 * s2 + 3 * s4 + 2 * rows + s2 + rows,
             E * h * (4 * d + 10), again=again + 14 * eh)

    # K9, K10 and K11 at 3o GATv2's shapes: int32 indptr and col;
    # bfloat16 rows q, k, dy and num, dq, dk (2 N H O bytes each) and a
    # (2 O H); float32 state and s_n (4 N H each) and da (4 O H). K10's da
    # is float32 either way: held to its plain version run in float64, as
    # 2c holds the float32 kernel's (DA_ATOL_REL), and its dq timed and
    # compared alone (the launches are the same).
    for h, o in GATV2_SHAPES:
        q, k, dy, sl, sv = (rn(N, h, o), rn(N, h, o), rn(N, h, o),
                            rn(N, h), rn(N, h, o))
        a = (torch.randn(o, h, generator=gen, device=dev)
             * (2.0 / (o + h)) ** 0.5).to(bf)   # Glorot's scale
        hd = f"H={h} O={o}"
        idx, s4, rows = 4 * (N + 1 + E), 4 * N * h, 2 * N * h * o
        # with no L2 reuse: a gathered row (2 bytes a value) an edge, and
        # K11's three receiver scalars (4 bytes each)
        again, eh = 2 * (E - N) * h * o, (E - N) * h
        num, m, s_ = case("k9_bf16", hd, ES.gatv2_softmax,
                          ES.gatv2_softmax_plain, (ir, cr, q, k, a, 0.2),
                          idx + 3 * rows + 2 * o * h + 2 * s4,
                          E * h * (6 * o + 6), again=again)
        out, mx, den = ES.finalize_softmax(num, m, s_, sl, sv)
        bwd = (q, k, a, mx, den, (out.float() * dy.float()).sum(-1), dy,
               0.2)
        da64 = ES.gatv2_bwd_dq_plain(
            ir, cr, *[t.double() if torch.is_tensor(t) else t
                      for t in bwd])[1]
        err = compare(f"K10_BF16 {hd} da vs float64",
                      ES.gatv2_bwd_dq(ir, cr, *bwd)[1], da64,
                      atol=DA_ATOL_REL * float(da64.abs().max()))
        res["k10_bf16"]["err"] = max(res["k10_bf16"]["err"], err)
        del da64
        case("k10_bf16", hd, lambda *a_: ES.gatv2_bwd_dq(*a_)[0],
             lambda *a_: ES.gatv2_bwd_dq_plain(*a_)[0], (ir, cr) + bwd,
             idx + 4 * rows + 3 * s4 + 2 * o * h + 4 * o * h,
             E * h * (11 * o + 8), again=again)
        case("k11_bf16", hd, ES.gatv2_bwd_rev, ES.gatv2_bwd_rev_plain,
             (is_, cs) + bwd, idx + 4 * rows + 3 * s4 + 2 * o * h,
             E * h * (11 * o + 8), again=2 * again + 12 * eh)
        del q, k, dy, sl, sv, num, out, bwd

    # K6, K7 and K8 at 2d's shapes (3o Transformer's and AGNN's): int32
    # indptr and col; bfloat16 rows q, k, v, dy and num, dq, dk, dv (2 N H
    # O or 2 N H D bytes each); float32 state and s_n (4 N H each) and raw
    # logits (4 E H). K6 writes the raw logits and K7 reads them, as
    # DotAttentionFunction calls them; AGNN's K6 and K7 take rows, the last
    # head's both the strips (asserted).
    o_s = BF16_STRIP_HEAD
    for h, o, d, slope in DOT_SHAPES + ((1, o_s, o_s, None),):
        q, k, v, dy = rn(N, h, o), rn(N, h, o), rn(N, h, d), rn(N, h, d)
        scale = o ** -0.5
        hd = f"H={h} O={o} D={d}" + ("" if slope is None else
                                     f" slope={slope}")
        ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
        lay6 = ES._dot_recv_layout(ov, dv, vec, N, N, E, 2)
        lay7 = ES._dot_recv_layout(ov, dv, vec, N, N, E, 2, 7)
        lay8 = ES._dot_bwd_rev_layout(ov, dv, N, E, vec, 2)
        log(f"  K6/K7/K8 bf16 {hd}: rows take {vec}-byte vectors; K6 "
            f"{lay6}, K7 {lay7} (strips, log2 rows, unroll, cap), K8 "
            f"{lay8} (log2 rows, unroll, cap, stages)")
        if (h, o) == (1, D) and (lay6[0] or lay7[0]):
            raise AssertionError(f"K6 and K7 bf16 at (1, {o}, {o}) must take "
                                 "rows")
        if o == o_s and not (lay6[0] and lay7[0]):
            raise AssertionError(f"K6 and K7 bf16 at (1, {o}, {o}) must take "
                                 "the strips")
        idx, nh, eh = 4 * (N + 1 + E), 4 * N * h, 4 * E * h
        no_, nd = 2 * N * h * o, 2 * N * h * d
        # with no L2 reuse every edge reads a whole gathered row (K6, K7:
        # k[s] and v[s]; K8: q[r] and dy[r]; 2 bytes a value) and K8 the
        # receivers' mx, den and s_n (4 bytes each)
        rows_again = 2 * (E - N) * h * (o + d)
        raws = [torch.empty(E, h, device=dev) for _ in range(2)]

        def k6(*a, _raw=raws[0]):
            return ES.dot_softmax(*a, _raw) + (_raw,)

        def k6_plain(*a, _raw=raws[1]):
            return ES.dot_softmax_plain(*a, _raw) + (_raw,)

        num, m, s_, raw = case("k6_bf16", hd, k6, k6_plain,
                               (ir, cr, q, k, v, scale, slope),
                               idx + 2 * no_ + 2 * nd + 2 * nh + eh,
                               E * h * (2 * o + 2 * d + 8), again=rows_again,
                               layout=lay6)
        out, mx, den = ES.finalize_softmax(num, m, s_, rn(N, h),
                                           rn(N, h, d))
        bwd = (q, k, v, mx, den, (out.float() * dy.float()).sum(-1), dy,
               scale, slope)
        case("k7_bf16", hd, ES.dot_bwd_dq, ES.dot_bwd_dq_plain,
             (ir, cr) + bwd + (raw,), idx + 2 * no_ + 2 * nd + 3 * nh + eh,
             E * h * (2 * o + 2 * d + 10), again=rows_again, layout=lay7)
        case("k8_bf16", hd, ES.dot_bwd_rev, ES.dot_bwd_rev_plain,
             (is_, cs) + bwd, idx + 3 * no_ + 3 * nd + 3 * nh,
             E * h * (4 * o + 4 * d + 10),
             again=rows_again + 3 * 4 * (E - N) * h, layout=lay8)
        del q, k, v, dy, num, out, bwd, raw, raws
    for key, r in res.items():
        for v in r["variants"]:
            log(f"  time {key.upper():<8} {v['case']:<24} "
                f"kernel={v['ms']:.4f} ms device={v['device_ms']:.4f} ms "
                f"(float32 kernel device={v['f32_device_ms']:.4f} ms) "
                f"host={v['host_us']:.1f} us plain={fmt_ms(v['plain_ms'])} "
                f"library={fmt_ms(v['library_ms'])} (device "
                f"{fmt_ms(v['library_device_ms'])}) bound="
                f"{v['bound_ms']:.4f} ms ({v['bound_by']}) no-reuse bound="
                f"{v['no_reuse_bound_ms']:.4f} ms"
                + (f" layout={tuple(v['layout'])}" if "layout" in v else ""))
    return res


def attention_phase(g, card: str) -> dict:
    """K12, K3, K4 and K5 against their plain versions at the GAT path's
    shapes: (H, D) = (4, 32) (layer 1) and (1, 8) (layer 2)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ir, cr, is_, cs = g.indptr_r, g.col_r, g.indptr_s, g.col_s
    res = {k: {"err": 0.0, "variants": []} for k in ("k3", "k4", "k5",
                                                      "k12")}
    log(f"phase 2b: attention kernels vs plain versions (N={N}, E={E}, "
        "float32)")

    case = functools.partial(kernel_case, res, card)

    for h, d in ((4, 32), (1, OUT_D)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        pi, pj, v, dy = rn(N, h), rn(N, h), rn(N, h, d), rn(N, h, d)
        lg, sl, sv = rn(E, h), rn(N, h), rn(N, h, d)
        mask = (torch.rand(E, h, generator=gen, device=dev) < 0.4) / 0.4
        ve = rn(E, h, d)
        hd = f"H={h} D={d}"
        # compulsory bytes, float32 and int32 (4 bytes each): indptr N+1;
        # col E; per-node scalars N*H each; per-edge logits/masks E*H each;
        # value rows N*H*D (or E*H*D for edge values) and outputs once.
        idx, nh, nhd = 4 * (N + 1 + E), 4 * N * h, 4 * N * h * d
        # the no-reuse bound adds what the per-edge gathers read again when
        # L2 keeps nothing: a value row per edge for a node-table row, and
        # one scalar per edge for each gathered per-node scalar
        rows_again, scalar_again = 4 * E * h * d - nhd, 4 * E * h - nh
        fwd_ops = E * h * (2 * d + 6)   # lrelu/max, exp, sum, D fma
        case("k12", f"node values {hd}", ES.edge_softmax,
             ES.edge_softmax_plain, (ir, cr, lg, None, v),
             idx + 4 * E * h + nhd + nhd + 2 * nh, fwd_ops, rows_again)
        case("k12", f"node values + dropout mask {hd}", ES.edge_softmax,
             ES.edge_softmax_plain, (ir, cr, lg, mask, v),
             idx + 8 * E * h + nhd + nhd + 2 * nh, fwd_ops, rows_again)
        case("k12", f"edge values + dropout mask {hd}", ES.edge_softmax,
             ES.edge_softmax_plain, (ir, None, lg, mask, ve),
             4 * (N + 1) + 8 * E * h + 4 * E * h * d + nhd + 2 * nh,
             fwd_ops, 0)
        # K3 gathers pj and the value rows of the senders
        num, m, s = case("k3", hd, ES.gat_softmax, ES.gat_softmax_plain,
                         (ir, cr, pi, pj, v, 0.2),
                         idx + 2 * nh + nhd + nhd + 2 * nh, fwd_ops,
                         rows_again + scalar_again)
        out, mx, den = ES.finalize_softmax(num, m, s, sl, sv)
        bwd = (pi, pj, v, mx, den, (out * dy).sum(-1), dy, 0.2)
        # five per-node scalars in, v and dy rows in, dpi (K4) or dpj and
        # dv (K5) out. K4 gathers pj and v rows of the senders, K5 pi, mx,
        # den, s_n and dy rows of the receivers.
        case("k4", hd, ES.gat_bwd_dpi, ES.gat_bwd_dpi_plain, (ir, cr) + bwd,
             idx + 5 * nh + 2 * nhd + nh, E * h * (2 * d + 10),
             rows_again + scalar_again)
        case("k5", hd, ES.gat_bwd_rev, ES.gat_bwd_rev_plain,
             (is_, cs) + bwd, idx + 5 * nh + 2 * nhd + nh + nhd,
             E * h * (4 * d + 10), rows_again + 4 * scalar_again)
        del ve, lg, mask
    log_times(res, 38)
    return res


def gatv2_phase(g, card: str) -> dict:
    """K9, K10 and K11 against their plain versions at the GATv2 path's
    shapes: (H, O) = (4, 32) (layer 1) and (1, 8) (layer 2)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(2)
    ir, cr, is_, cs = g.indptr_r, g.col_r, g.indptr_s, g.col_s
    res = {k: {"err": 0.0, "variants": []} for k in ("k9", "k10", "k11")}
    log(f"phase 2c: GATv2 kernels vs plain versions (N={N}, E={E}, "
        "float32)")

    case = functools.partial(kernel_case, res, card)

    for h, o in ((GAT_HEADS, D // GAT_HEADS), (1, OUT_D)):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale
        # a at Glorot's scale, so that the logits spread as in training
        q, k, dy = rn(N, h, o), rn(N, h, o), rn(N, h, o)
        a = rn(o, h, scale=(2.0 / (o + h)) ** 0.5)
        hd = f"H={h} O={o}"
        # compulsory bytes, float32 and int32 (4 bytes each): indptr N+1;
        # col E; per-node scalars N*H each; rows q, k, dy and outputs
        # N*H*O each; a and da O*H. K10's per-block shares of da are
        # scratch (H*O*B floats, B its blocks per head) and not counted.
        idx, nh, nhd, ah = 4 * (N + 1 + E), 4 * N * h, 4 * N * h * o, 4 * o * h
        # with no L2 reuse every edge reads a whole row per gathered row
        # operand (K9 and K10: k[s]; K11: q[r] and dy[r]) and K11 one
        # scalar per edge for each of mx, den and s_n of the receivers
        rows_again, scalar_again = 4 * E * h * o - nhd, 4 * E * h - nh
        num, m, s = case(
            "k9", hd, ES.gatv2_softmax, ES.gatv2_softmax_plain,
            (ir, cr, q, k, a, 0.2), idx + 3 * nhd + ah + 2 * nh,
            E * h * (6 * o + 6),    # add, lrelu, logit fma, value fma; exp
            rows_again, [(nm, {}, None) for nm in ("num", "m", "s")])
        out, mx, den = ES.finalize_softmax(num, m, s, rn(N, h), rn(N, h, o))
        bwd = (q, k, a, mx, den, (out * dy).sum(-1), dy, 0.2)
        da64 = ES.gatv2_bwd_dq_plain(
            ir, cr, *[t.double() if torch.is_tensor(t) else t
                      for t in bwd])[1]
        da_tol = {"atol": DA_ATOL_REL * float(da64.abs().max())}
        compare(f"K10 {hd} da, plain float32 vs float64 (info)",
                ES.gatv2_bwd_dq_plain(ir, cr, *bwd)[1], da64,
                atol=float("inf"))
        # add, lrelu, logit and <k, dy> fma, dq and da (or dk) updates
        bwd_ops = E * h * (11 * o + 8)
        case("k10", hd, ES.gatv2_bwd_dq, ES.gatv2_bwd_dq_plain,
             (ir, cr) + bwd, idx + 4 * nhd + 3 * nh + 2 * ah, bwd_ops,
             rows_again, [("dq", {}, None), ("da vs float64", da_tol, da64)])
        # the dq walk and the da reduce apart, from its device_ms record
        v10 = res["k10"]["variants"][-1]
        v10["walk_ms"], v10["reduce_ms"] = _split_k10(DEVICE_RECORDS[-1])
        log(f"  K10 {hd} device ms: dq walk {v10['walk_ms']:.4f}, da reduce "
            f"{v10['reduce_ms']:.4f}")
        case("k11", hd, ES.gatv2_bwd_rev, ES.gatv2_bwd_rev_plain,
             (is_, cs) + bwd, idx + 4 * nhd + 3 * nh + ah, bwd_ops,
             2 * rows_again + 3 * scalar_again, [("dk", {}, None)])
        del q, k, dy, num, out, bwd, da64
    log_times(res, 12)
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return res


# (H, O, D, slope) of the dot-attention paths: Transformer layer 1, its
# head layer, AGNN (K6 and K7 in strips) and layer 1 with a slope
DOT_SHAPES = ((GAT_HEADS, D // GAT_HEADS, D // GAT_HEADS, None),
              (1, OUT_D, OUT_D, None), (1, D, D, None),
              (GAT_HEADS, D // GAT_HEADS, D // GAT_HEADS, 0.2))


# 2h's one-head bfloat16 dot attention whose K6 takes the strips: 33
# bf16x8 vectors a row, wider than _DOT_BF16_ROWS_BYTES (its 66 MiB table
# exceeds _DOT_STRIP_BYTES), two register chunks for K8's staged kernel
BF16_STRIP_HEAD = 264


def dot_phase(g, card: str) -> dict:
    """K6, K7 and K8 against their plain versions at the dot-attention
    paths' shapes: (H, O, D) = (4, 32, 32) (Transformer layer 1), (1, 8, 8)
    (its head layer), (1, 128, 128) (AGNN), and (4, 32, 32) with a
    leaky_relu slope."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(3)
    ir, cr, is_, cs = g.indptr_r, g.col_r, g.indptr_s, g.col_s
    res = {k: {"err": 0.0, "variants": []} for k in ("k6", "k7", "k8")}
    log(f"phase 2d: dot-attention kernels vs plain versions (N={N}, E={E}, "
        "float32)")

    case = functools.partial(kernel_case, res, card)

    for h, o, d, slope in DOT_SHAPES:
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        # scale 1/sqrt(O), as TransformerConv: logits of unit spread
        q, k, v, dy, scale = rn(N, h, o), rn(N, h, o), rn(N, h, d), \
            rn(N, h, d), o ** -0.5
        hd = f"H={h} O={o} D={d}" + ("" if slope is None else
                                     f" slope={slope}")
        # compulsory bytes, float32 and int32 (4 bytes each): indptr N+1;
        # col E; per-node scalars N*H each; per-edge raw logits E*H; rows
        # q, k (N*H*O), v, dy (N*H*D) and the outputs once
        idx, nh, eh = 4 * (N + 1 + E), 4 * N * h, 4 * E * h
        no_, nd = 4 * N * h * o, 4 * N * h * d
        # with no L2 reuse every edge reads a whole row per gathered row
        # operand (K6 and K7: k[s] and v[s]; K8: q[r] and dy[r]) and K8 one
        # scalar per edge for each of mx, den and s_n of the receivers
        rows_again = 4 * E * h * (o + d) - no_ - nd
        scalar_again = 4 * E * h - nh
        # as the main path calls them: K6 also writes each edge's raw
        # logit, which K7 reads in place of q (DotAttentionFunction)
        raws = [torch.empty(E, h, device=dev) for _ in range(2)]

        def k6(*a, _raw=raws[0]):
            return ES.dot_softmax(*a, _raw) + (_raw,)

        def k6_plain(*a, _raw=raws[1]):
            return ES.dot_softmax_plain(*a, _raw) + (_raw,)

        num, m, s, raw = case(
            "k6", hd, k6, k6_plain, (ir, cr, q, k, v, scale, slope),
            idx + 2 * no_ + 2 * nd + 2 * nh + eh,
            E * h * (2 * o + 2 * d + 8),    # dot, value fma; exp, rescale
            rows_again, [(nm, {}, None) for nm in ("num", "m", "s", "raw")])
        out, mx, den = ES.finalize_softmax(num, m, s, rn(N, h), rn(N, h, d))
        bwd = (q, k, v, mx, den, (out * dy).sum(-1), dy, scale, slope)
        # K7: <v[s], dy[r]> per edge, then the dq update
        case("k7", hd, ES.dot_bwd_dq, ES.dot_bwd_dq_plain,
             (ir, cr) + bwd + (raw,), idx + 2 * no_ + 2 * nd + 3 * nh + eh,
             E * h * (2 * o + 2 * d + 10), rows_again, [("dq", {}, None)])
        # K8: two dots per edge, then the dk and dv updates
        case("k8", hd, ES.dot_bwd_rev, ES.dot_bwd_rev_plain, (is_, cs) + bwd,
             idx + 3 * no_ + 3 * nd + 3 * nh, E * h * (4 * o + 4 * d + 10),
             rows_again + 3 * scalar_again, [("dk", {}, None),
                                             ("dv", {}, None)])
        del q, k, v, dy, num, out, bwd, raw, raws
    log_times(res, 26)
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return res


def sddmm_phase(g, card: str) -> dict:
    """K13 against its plain version at D = 128 (``DotDecoder`` at the
    link path's width), 32, 512 and (H, D) = (4, 32)
    (``dot_attention_logits`` of Transformer layer 1), with the library
    yardstick ``torch.sparse.sampled_addmm`` (the receiver CSR with all-ones
    values times ``xi @ xj^T``) and the plain two-gather ``xi_dot_xj``
    (what a CPU tensor takes, run on the card) beside it; and K13's
    backward, K1 twice, against the plain autograd."""
    from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(6)
    ir, cr = g.indptr_r, g.col_r
    res = {"k13": {"err": 0.0, "variants": []}}
    log(f"phase 2e: SDDMM kernel vs plain version (N={N}, E={E}, float32)")
    for h, d in ((1, D), (1, 32), (1, 512), (GAT_HEADS, D // GAT_HEADS)):
        xi = torch.randn(N, h, d, generator=gen, device=dev)
        xj = torch.randn(N, h, d, generator=gen, device=dev)
        # the library yardstick: the receiver CSR with all-ones values
        # times xi @ xj^T, batched over the heads where there are several
        if h == 1:
            pattern = torch.sparse_csr_tensor(
                ir, cr, torch.ones(E, device=dev), (N, N))
            a, b = xi[:, 0], xj[:, 0].t()
        else:
            pattern = torch.sparse_csr_tensor(
                ir.expand(h, -1).contiguous(), cr.expand(h, -1).contiguous(),
                torch.ones(h, E, device=dev), (h, N, N))
            a, b = xi.transpose(0, 1).contiguous(), xj.permute(1, 2, 0)

        def lib():
            return torch.sparse.sampled_addmm(pattern, a, b, beta=0.0)

        # compulsory bytes: indptr, col, both node tables and out once; with
        # no L2 reuse every edge reads its sender's row
        byt = 4 * (N + 1 + E) + 2 * 4 * N * h * d + 4 * E * h
        case = f"H={h} D={d}" if h > 1 else f"D={d}"
        compare(f"K13 {case} vs sampled_addmm", SD.sddmm_csr(ir, cr, xi, xj),
                lib().values().reshape(h, E).t())
        kernel_case(res, card, "k13", case, SD.sddmm_csr, SD.sddmm_plain,
                    (ir, cr, xi, xj), byt, 2 * E * h * d,
                    4 * E * h * d - 4 * N * h * d, lib=lib)
        v = res["k13"]["variants"][-1]
        r, s = g.receivers, g.senders
        v["two_gather_ms"] = cuda_ms(
            lambda: (xi.index_select(0, r) * xj.index_select(0, s)).sum(-1),
            warmup=1, batches=3, per_batch=2)
        log(f"  time K13 {case:<10} two-gather xi_dot_xj="
            f"{v['two_gather_ms']:.4f} ms")
        del xi, xj, pattern, a, b
    log_times(res, 10)
    # the backward: K1 over the receiver CSR (dxi) and over the sender CSR
    # (dxj), one launch each at H = 1
    xi = torch.randn(N, D, generator=gen, device=dev)
    xj = torch.randn(N, D, generator=gen, device=dev)
    dl = torch.randn(E, generator=gen, device=dev)
    grads = []
    for fn in (lambda a, b: SD.sddmm(g, a, b),
               lambda a, b: SD.sddmm_plain(ir, cr, a[:, None],
                                           b[:, None])[:, 0]):
        a, b = xi.clone().requires_grad_(), xj.clone().requires_grad_()
        (fn(a, b) * dl).sum().backward()
        grads.append((a.grad, b.grad))
    res["k13"]["err"] = max(res["k13"]["err"],
                            compare("K13 backward dxi (K1)", grads[0][0],
                                    grads[1][0]),
                            compare("K13 backward dxj (K1)", grads[0][1],
                                    grads[1][1]))
    return res


def _empty_rows(indptr: torch.Tensor, every: int) -> tuple[torch.Tensor,
                                                            int]:
    """A copy of ``indptr`` whose rows 0, every, 2 * every, ... have no
    entries (each gives its entries to the next row), and their count."""
    out = indptr.clone()
    idx = torch.arange(1, indptr.numel() - 1, every, device=indptr.device)
    out[idx] = indptr[idx - 1]
    return out, idx.numel()


def same_bits(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """``got`` equals ``ref`` exactly, NaN where ``ref`` is NaN."""
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    ok = got.shape == ref.shape and bool(same.all())
    log(f"  {name:<44} {'equal bits' if ok else 'FAIL'} "
        f"(NaN {int(torch.isnan(ref).sum())}, "
        f"+-inf {int(torch.isinf(ref).sum())})")
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree")


def segment_phase(g, gb, card: str) -> dict:
    """K14 (max and min) and its backward against their plain versions over
    the main graph's receiver CSR at F = 128, 8 and 4 and over the graph
    CSR of the 3k batch at F = 64.

    The checks run on values rounded to a grid of 1/4 (exact ties), with
    one NaN entry, over a copy of the CSR with rows emptied: a max picks one
    of its inputs and the backward divides the same cotangent by the same
    count, so kernel and plain version agree bit for bit (tolerance 0). The
    times run over the CSR as it is, beside the plain version, the library
    yardstick ``torch.segment_reduce(data, "max", offsets=indptr)`` and
    ``scatter_reduce("amax")`` over the expanded row ids.
    """
    from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG
    from graphneuralnetworks_tpu_torch.ops.cuda.spmm import _row_ids

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(9)
    res = {"k14": {"err": 0.0, "variants": []},
           "k14_bwd": {"err": 0.0, "variants": []}}
    bw = peaks(card)[0]
    log("phase 2f: segment-max kernel K14 and its backward vs plain "
        "versions (float32)")
    cases = [("receiver CSR F=128 (EdgeConv layer 1)", g.indptr_r, D, 1024),
             ("receiver CSR F=8 (EdgeConv layer 2)", g.indptr_r, OUT_D,
              1024),
             ("receiver CSR F=4 ([E, H] logits, H=4)", g.indptr_r,
              GAT_HEADS, 1024),
             (f"graph CSR of the 3k batch F={TUD_HIDDEN}", gb.indptr_g,
              TUD_HIDDEN, 64)]
    for label, ip, f, every in cases:
        n_rows, rows = ip.numel() - 1, int(ip[-1])
        data = torch.round(torch.randn(rows, f, generator=gen, device=dev)
                           * 4) / 4
        dy = torch.randn(n_rows, f, generator=gen, device=dev)
        checked = data.clone()
        checked[rows // 3, f // 2] = float("nan")
        holes, n_holes = _empty_rows(ip, every)
        for op, kern, plain in (("max", SG.segment_max_csr,
                                 SG.segment_max_plain),
                                ("min", SG.segment_min_csr,
                                 SG.segment_min_plain)):
            want = plain(holes, checked)
            same_bits(f"K14 {op} {label}", kern(holes, checked), want)
            empty = int(torch.isinf(want).all(1).sum())
            if empty < n_holes or int(torch.isnan(want).sum()) != 1:
                raise AssertionError(f"K14 {op} {label}: {empty} rows "
                                     f"without entries (>= {n_holes} "
                                     "expected) or no NaN")
        out = SG.segment_max_plain(holes, checked)
        same_bits(f"K14 backward {label}",
                  SG.segment_max_bwd_csr(holes, checked, out, dy),
                  SG.segment_max_bwd_plain(holes, checked, out, dy))
        rid = _row_ids(holes, rows)
        count = torch.zeros_like(out).index_add_(
            0, rid, (checked == out.index_select(0, rid)).float())
        ties = int((count >= 2).sum())
        log(f"  {label}: {ties} of {count.numel()} maxima tied "
            f"({100 * ties / count.numel():.1f} %)")
        if ties == 0:
            raise AssertionError(f"{label}: the grid made no ties")

        # times over the CSR as it is, no NaN
        out = SG.segment_max_csr(ip, data)
        same_bits(f"K14 {label} vs torch.segment_reduce", out,
                  torch.segment_reduce(data, "max", offsets=ip))
        rid = _row_ids(ip, rows)[:, None].expand(rows, f)
        init = torch.full((n_rows, f), float("-inf"), device=dev)
        # compulsory bytes: indptr, the entries and the outputs once each
        # (the rows are contiguous: with no L2 reuse the kernel reads no
        # more); the backward reads indptr, the entries, out and dy and
        # writes ddata, and with no L2 reuse its second sweep reads the
        # entries again
        byt = 4 * (n_rows + 1) + 4 * rows * f + 4 * n_rows * f
        b_ms, b_by = bound(byt, rows * f, card)
        res["k14"]["variants"].append({
            "case": label, "f": f,
            **timings(lambda: SG.segment_max_csr(ip, data),
                      lambda: SG.segment_max_plain(ip, data),
                      lambda: torch.segment_reduce(data, "max", offsets=ip)),
            "scatter_reduce_ms": cuda_ms(lambda: init.scatter_reduce(
                0, rid, data, "amax", include_self=False)),
            "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": byt / bw * 1e3, "max_abs_err": 0.0})
        byt_b = 4 * (n_rows + 1) + 8 * rows * f + 8 * n_rows * f
        b_ms, b_by = bound(byt_b, 2 * rows * f, card)
        res["k14_bwd"]["variants"].append({
            "case": label, "f": f,
            **timings(lambda: SG.segment_max_bwd_csr(ip, data, out, dy),
                      lambda: SG.segment_max_bwd_plain(ip, data, out, dy)),
            "bound_ms": b_ms, "bound_by": b_by,
            "no_reuse_bound_ms": (byt_b + 4 * rows * f) / bw * 1e3,
            "max_abs_err": 0.0})
        log(f"  time K14 {label:<40} scatter_reduce="
            f"{res['k14']['variants'][-1]['scatter_reduce_ms']:.4f} ms")
        del data, dy, checked, out, rid, init, count
    log_times(res, 40)
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return res


def _k1_cases(g, seed: int, exact: bool = False) -> list:
    """K1's cases of phase 2 that phase 3 launches, on ``g``: ``(label,
    args)`` with ``args`` as ``spmm_csr`` takes them. ``exact``: rows of
    integers in [-8, 8] and weights 1 or 2, so that every partial sum of a
    row of fewer than 2^20 edges is an integer float32 holds exactly: any
    summation order gives the same bits."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ir, cr, is_, cs, es = (g.indptr_r, g.col_r, g.indptr_s, g.col_s,
                           g.eid_s)
    n, e = g.num_nodes, g.num_edges

    def rows(*shape):
        if exact:
            return torch.randint(-8, 9, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev)

    x, x8, x7 = rows(n, D), rows(n, OUT_D), rows(n, 7)
    e8, e128 = rows(e, OUT_D), rows(e, D)
    w = (torch.randint(1, 3, (e,), generator=gen, device=dev).float()
         if exact else torch.rand(e, generator=gen, device=dev) + 0.5)
    return [("fwd receiver-CSR D=128", (ir, cr, None, None, x)),
            ("bwd sender-CSR weighted D=128", (is_, cs, es, w, x)),
            ("fwd receiver-CSR D=8", (ir, cr, None, None, x8)),
            ("bwd sender-CSR D=8", (is_, cs, es, None, x8)),
            ("gather-bwd edge rows D=8", (ir, None, None, None, e8)),
            ("gather-bwd edge rows D=128", (ir, None, None, None, e128)),
            ("gather-bwd edge rows by eid D=128", (is_, es, None, None,
                                                   e128)),
            ("fwd receiver-CSR D=7 (scalar path)", (ir, cr, None, w, x7))]


def _k1_chosen(S, args):
    src, indptr = args[-1], args[0]
    d = src.shape[1]
    vec = d % 4 == 0
    n_edges = args[1].numel() if args[1] is not None else src.shape[0]
    return S._spmm_layout(d // 4 if vec else d, 16 if vec else 4,
                          src.shape[0], indptr.numel() - 1, n_edges)


def k1_layout_sweep(cases) -> list:
    """K1 at every layout (log2 rows per warp, log2 strip vectors, gathers
    in flight per edge group, register cap) the width allows, on each
    ``(label, args)`` of ``cases``, each held to the plain version at RTOL /
    ATOL before it is timed (device ms). Explicit layouts run from the
    sweep build."""
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    rows_out = []
    for label, args in cases:
        d = args[-1].shape[1]
        fv = d // 4 if d % 4 == 0 else d
        chosen = _k1_chosen(S, args)
        ref = S.spmm_plain(*args)
        # strips narrower than the row's G for wide rows only
        log_g = min((fv - 1).bit_length(), 5)
        for lay in [(log_rows, strip, unroll, cap)
                    for strip in ((3, 4, 5) if log_g == 5 else (log_g,))
                    for log_rows in range(6 - strip)
                    for unroll in (1, 2, 4, 8) for cap in (0, 64)]:
            err = compare(f"K1 {label} {lay}",
                          S._spmm_csr_kernel(*args, layout=lay), ref,
                          quiet=True)
            row = {"case": label, "log_rows": lay[0], "log_strip": lay[1],
                   "unroll": lay[2], "reg_cap": lay[3],
                   "chosen": lay == chosen,
                   "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: S._spmm_csr_kernel(*args, layout=lay))}
            rows_out.append(row)
            log(f"  K1 {label:<34} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del ref
    return rows_out


def k1_sweep(g) -> dict:
    """K1 at every layout (rows per warp, strip width, gathers in flight per
    edge group, register cap) the width allows, at phase 2's shapes that phase
    3 launches, each held to the plain version at RTOL / ATOL before it is
    timed (device ms): the measurement behind ``ops/cuda/spmm.py``'s
    ``_K1_*`` constants. Then the gather-rate ceiling at D=128: the same
    receiver CSR rows with (a) the graph's random senders, (b) senders
    drawn from the first 16 MB of the table (32,768 rows, which the L2
    holds) and (c) ``col[e] = e mod N`` (the table read in order), each
    with whole rows one gather at a time (the first port's order), whole
    rows eight gathers in flight, and strips of 8 vectors (the chosen
    layout for the table). Explicit layouts run from the sweep build."""
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev = g.device
    ir, cr = g.indptr_r, g.col_r
    out = {"k1": [], "k1_ceiling": []}
    log("sweep: K1 layouts (device ms, profiler; log2 rows per warp, log2 "
        "strip vectors, gathers in flight, register cap)")
    cases = _k1_cases(g, 12)
    x = cases[0][1][-1]
    out["k1"] = k1_layout_sweep(cases)
    del cases
    # the gather-rate ceiling: K1 over the receiver CSR at D=128 with the
    # senders replaced, at each gathers-in-flight
    slice_rows = 16 * 2**20 // (4 * D)
    e_ids = torch.arange(E, device=dev, dtype=torch.int32)
    for label, col in (("(a) random senders", cr),
                       ("(b) senders in a 16 MB slice",
                        torch.remainder(cr, slice_rows)),
                       ("(c) col[e] = e mod N, in order",
                        torch.remainder(e_ids, N))):
        args = (ir, col.contiguous(), None, None, x)
        ref = S.spmm_plain(*args)
        for lay in ((0, 5, 1, 0), (0, 5, 8, 64), (2, 3, 8, 64)):
            err = compare(f"K1 ceiling {label} {lay}",
                          S._spmm_csr_kernel(*args, layout=lay), ref,
                          quiet=True)
            t = device_ms(lambda: S._spmm_csr_kernel(*args, layout=lay))
            out["k1_ceiling"].append({
                "case": label, "layout": lay, "device_ms": t,
                "max_abs_err": err, "gathered_tb_s": 4 * E * D / t / 1e9})
            log(f"  K1 ceiling D=128 {label:<32} {lay}: {t:.4f} ms"
                f" ({4 * E * D / t / 1e9:.2f} TB/s of gathered rows)")
        del ref
    return out


def _k2_cases(g, seed: int, exact: bool = False) -> list:
    """K2's cases of phase 2 that phase 3 launches, on ``g``: ``(label,
    args)`` with ``args`` as ``spmm_sddmm`` takes them. ``exact``: rows of
    integers in [-8, 8] and weights 1 or 2, so that every sum (``dx``
    over a row's edges, ``dw`` over a row's D floats) is of integers that
    float32 holds exactly: any summation order gives the same bits."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    is_, cs, es = g.indptr_s, g.col_s, g.eid_s
    n, e = g.num_nodes, g.num_edges

    def rows(*shape):
        if exact:
            return torch.randint(-8, 9, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev)

    def weights(*shape):
        if exact:
            return torch.randint(1, 3, shape, generator=gen,
                                 device=dev).float()
        return torch.rand(*shape, generator=gen, device=dev) + 0.5

    hd = (n, GAT_HEADS, D // GAT_HEADS)
    return [(f"D={D} (3b layer 1)", (is_, cs, es, weights(e), rows(n, D),
                                     rows(n, D))),
            (f"H={GAT_HEADS} D={D // GAT_HEADS} (3e layer 1)",
             (is_, cs, es, weights(e, GAT_HEADS), rows(*hd), rows(*hd))),
            (f"D={OUT_D} (3b, 3e layer 2)",
             (is_, cs, es, weights(e), rows(n, OUT_D), rows(n, OUT_D)))]


def _k2_chosen(S, args):
    indptr, col, dy, x = args[0], args[1], args[4], args[5]
    d = x.shape[-1]
    vec = d % 4 == 0
    return S._spmm_sddmm_layout(d // 4 if vec else d, 16 if vec else 4,
                                dy.shape[0], indptr.numel() - 1, col.numel(),
                                1 if x.dim() == 2 else x.shape[1])


def k2_sweep(g) -> list:
    """K2 at every layout (rows per warp, strip width, gathers in flight per
    edge group, register cap; narrower strips only for rows of 32 vectors,
    as K1's sweep; weights and dots by sender-CSR position or by edge id)
    at the cases phase 3 launches (:func:`_k2_cases`), each
    held to the plain version at RTOL / ATOL before it is timed (device
    ms): the measurement behind ``ops/cuda/spmm.py``'s ``_K2_*``
    constants. Explicit layouts run from the sweep build."""
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    out = []
    log("sweep: K2 layouts (device ms, profiler; log2 rows per warp, log2 "
        "strip vectors, gathers in flight, register cap, by position)")
    for label, args in _k2_cases(g, 21):
        d = args[-1].shape[-1]
        fv = d // 4 if d % 4 == 0 else d
        log_g = min((fv - 1).bit_length(), 5)
        chosen = _k2_chosen(S, args)
        ref = S.spmm_sddmm_plain(*args)
        for lay in [(log_rows, strip, unroll, cap, by_position)
                    for by_position in (1, 0)
                    for strip in ((3, 4, 5) if log_g == 5 else (log_g,))
                    for log_rows in range(6 - strip)
                    for unroll in (1, 2, 4, 8) for cap in (0, 64)]:
            got = S._spmm_sddmm_kernel(*args, layout=lay)
            err = max(compare(f"K2 {label} {lay} {nm}", a, b, quiet=True)
                      for nm, a, b in zip(("dx", "dw"), got, ref))
            row = {"case": label, "log_rows": lay[0], "log_strip": lay[1],
                   "unroll": lay[2], "reg_cap": lay[3],
                   "by_position": lay[4], "chosen": lay == chosen,
                   "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: S._spmm_sddmm_kernel(*args, layout=lay))}
            out.append(row)
            log(f"  K2 {label:<22} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del ref, got
    return out


GATV2_SHAPES = ((GAT_HEADS, D // GAT_HEADS), (1, OUT_D))
# the sweeps of --sweep (K6 and K7 are one, recv_sweep; skew the R-MAT graph)
SWEEPS = ("k1", "k2", "k3", "k4", "k5", "k6_k7", "k8", "k9", "k10", "k11",
          "bf16",
          "k12", "k14", "skew")
# parts of the bf16 sweep that run alone by name
SWEEP_PARTS = ("bf16_dot", "bf16_strips", "bf16_k7", "bf16_k2")


def _k11_args(ES, g, h, o, gen):
    """K11's arguments at (H, O) on ``g``: random q, k, dy, ``a`` at
    Glorot's scale, and the row max, denominator and ``<out, dy>`` of the
    forward K9 gives."""
    dev, n = g.device, g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q, k, dy = rn(n, h, o), rn(n, h, o), rn(n, h, o)
    a = rn(o, h) * (2.0 / (o + h)) ** 0.5
    num, m, s = ES.gatv2_softmax(g.indptr_r, g.col_r, q, k, a, 0.2)
    outp, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, o))
    return (g.indptr_s, g.col_s, q, k, a, mx, den, (outp * dy).sum(-1), dy,
            0.2)


def k11_sweep(g) -> list:
    """K11 at every layout (rows per warp, edges in flight per edge group,
    register cap, the receivers' scalars packed or not; a packed call's
    time includes its stack) the library's sweep build holds, at phase
    2c's shapes,
    each held to the plain version at RTOL / ATOL before it is timed
    (device ms): the measurement behind ``ops/cuda/edge_softmax.py``'s
    ``_K11_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(23)
    out = []
    log("sweep: K11 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap, packed scalars)")
    for h, o in GATV2_SHAPES:
        args = _k11_args(ES, g, h, o, gen)
        ref = ES.gatv2_bwd_rev_plain(*args)
        hd = f"H={h} O={o}"
        ov = o // 4
        chosen = ES._gatv2_bwd_rev_layout(ov, 16, N, E)
        for lay in [(log_rows, unroll, cap, packed) for packed in (0, 1)
                    for log_rows in range(6 - min((ov - 1).bit_length(), 5))
                    for unroll in (1, 2, 4) for cap in (0, 64)]:
            err = compare(f"K11 {hd} {lay}",
                          ES._gatv2_bwd_rev_kernel(*args, layout=lay), ref,
                          quiet=True)
            row = {"case": hd, "log_rows": lay[0], "unroll": lay[1],
                   "reg_cap": lay[2], "packed": lay[3],
                   "chosen": lay == chosen,
                   "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: ES._gatv2_bwd_rev_kernel(*args, layout=lay))}
            out.append(row)
            log(f"  K11 {hd:<12} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del args, ref
    return out


def _k10_args(ES, g, h, o, gen):
    """K10's arguments at (H, O) on ``g``: :func:`_k11_args` over the
    receiver CSR."""
    return (g.indptr_r, g.col_r) + _k11_args(ES, g, h, o, gen)[2:]


def _rows_layouts(wide: int) -> list:
    """The (log2 rows per warp, edges in flight, register cap) the sweep
    build holds for rows of ``wide`` vectors (K8's, K10's, K11's and K5's
    instances: U in {1, 2, 4} with NC * U <= 4, a cap only for NC <= 2)."""
    log_g = min((wide - 1).bit_length(), 5)
    nc = 1 << max(0, (wide - 1).bit_length() - 5)
    return [(log_rows, unroll, cap) for log_rows in range(6 - log_g)
            for unroll in (1, 2, 4) for cap in (0, 64)
            if nc * unroll <= 4 or unroll == 1 if cap == 0 or nc <= 2]


def _split_k10(record: dict) -> tuple[float, float]:
    """K10's device ms per call split into the dq walk and the da reduce,
    from one ``DEVICE_RECORDS`` entry, each kernel counted as
    :func:`device_ms` counts it (its mean time times its launches a
    call)."""
    calls, walk, red = record["calls"], 0.0, 0.0
    for name, n in record["records"].items():
        t = (record["ms_per_call"][name] * calls / n
             * max(1, round(n / calls)))
        if "da_reduce" in name:
            red += t
        else:
            walk += t
    return walk, red


def k10_sweep(g) -> list:
    """K10 at every layout (rows per warp, edges in flight per edge group,
    register cap) the library's sweep build holds, at phase 2c's shapes,
    each held to the plain version first (``dq`` at RTOL / ATOL, ``da``
    against the plain version in float64 at DA_ATOL_REL) and timed (device
    ms, the dq walk and the da reduce apart): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K10_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(25)
    out = []
    log("sweep: K10 layouts (device ms, profiler, = dq walk + da reduce; "
        "log2 rows per warp, edges in flight, register cap)")
    for h, o in GATV2_SHAPES:
        args = _k10_args(ES, g, h, o, gen)
        dq_ref = ES.gatv2_bwd_dq_plain(*args)[0]
        da64 = ES.gatv2_bwd_dq_plain(*[
            t.double() if torch.is_tensor(t) and t.is_floating_point() else t
            for t in args])[1]
        da_atol = DA_ATOL_REL * float(da64.abs().max())
        hd = f"H={h} O={o}"
        chosen = ES._gatv2_bwd_dq_layout(o // 4, 16, N, E)
        for lay in _rows_layouts(o // 4):
            dq, da = ES._gatv2_bwd_dq_kernel(*args, layout=lay)
            err = max(compare(f"K10 {hd} {lay} dq", dq, dq_ref, quiet=True),
                      compare(f"K10 {hd} {lay} da vs float64", da, da64,
                              atol=da_atol, quiet=True))
            t = device_ms(lambda: ES._gatv2_bwd_dq_kernel(*args, layout=lay))
            walk, red = _split_k10(DEVICE_RECORDS[-1])
            row = {"case": hd, "log_rows": lay[0], "unroll": lay[1],
                   "reg_cap": lay[2], "chosen": lay == chosen,
                   "max_abs_err": err, "device_ms": t, "walk_ms": walk,
                   "reduce_ms": red}
            out.append(row)
            log(f"  K10 {hd:<12} {lay} {t:.4f} ms (= {walk:.4f} + "
                f"{red:.4f}){' (chosen)' * row['chosen']}")
        del args, dq_ref, da64
    return out


def _k9_args(g, h, o, gen):
    """K9's arguments at (H, O) on ``g``: random q and k, ``a`` at Glorot's
    scale (so that the logits spread as in training)."""
    dev, n = g.device, g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    a = rn(o, h) * (2.0 / (o + h)) ** 0.5
    return g.indptr_r, g.col_r, rn(n, h, o), rn(n, h, o), a, 0.2


def _k3_args(g, h, d, gen):
    """K3's arguments at (H, D) on ``g``: random pi, pj and v."""
    dev, n = g.device, g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return g.indptr_r, g.col_r, rn(n, h), rn(n, h), rn(n, h, d), 0.2


def _forward_sweep(key, fn, plain, args, hd, layouts, chosen, names):
    """Hold ``fn(*args, layout=lay)`` to ``plain(*args)`` at RTOL / ATOL
    for each of ``layouts``, then time it (device ms): one row each."""
    ref = plain(*args)
    out = []
    for lay in layouts:
        got = fn(*args, layout=lay)
        err = max(compare(f"{key.upper()} {hd} {lay} {nm}", a, b, quiet=True)
                  for nm, a, b in zip(names, got, ref))
        row = {"case": hd, "layout": list(lay), "chosen": lay == chosen,
               "max_abs_err": err,
               "device_ms": device_ms(lambda: fn(*args, layout=lay))}
        out.append(row)
        log(f"  {key.upper()} {hd:<12} {lay} {row['device_ms']:.4f} ms"
            f"{' (chosen)' * row['chosen']}")
    return out


def k9_sweep(g) -> list:
    """K9 at every layout (rows per warp, edges in flight per edge group,
    register cap) the library's sweep build holds, at phase 2c's shapes,
    each held to the plain version at RTOL / ATOL before it is timed
    (device ms): the measurement behind ``ops/cuda/edge_softmax.py``'s
    ``_K9_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(28)
    out = []
    log("sweep: K9 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap)")
    for h, o in GATV2_SHAPES:
        out += _forward_sweep(
            "k9", ES._gatv2_softmax_kernel, ES.gatv2_softmax_plain,
            _k9_args(g, h, o, gen), f"H={h} O={o}",
            _rows_layouts(o // 4), ES._gatv2_softmax_layout(o // 4, 16, N, E),
            ("num", "m", "s"))
    return out


def k3_sweep(g) -> list:
    """K3 at every layout (rows per warp, edges in flight per edge group,
    register cap, pj loaded ahead by the lane holding the index or by every
    lane of the group) the library's sweep build holds, at phase 2b's
    shapes, each held to the plain version at RTOL / ATOL before it is
    timed (device ms): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K3_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(29)
    out = []
    log("sweep: K3 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap, pj ahead)")
    for h, d in GATV2_SHAPES:
        out += _forward_sweep(
            "k3", ES._gat_softmax_kernel, ES.gat_softmax_plain,
            _k3_args(g, h, d, gen), f"H={h} D={d}",
            [lay + (ahead,) for ahead in (0, 1)
             for lay in _rows_layouts(d // 4)],
            ES._gat_softmax_layout(d // 4, 16, N, E), ("num", "m", "s"))
    return out


def _k4_args(ES, g, h, d, gen):
    """K4's arguments at (H, D) on ``g``: :func:`_k5_args` over the
    receiver CSR."""
    return (g.indptr_r, g.col_r) + _k5_args(ES, g, h, d, gen)[2:]


def _k4_as_tuples(ES):
    """K4's kernel and plain version returning ``(dpi,)``, as the other
    kernels return their outputs."""
    return (lambda *a, layout=None: (
                ES._gat_bwd_dpi_kernel(*a, layout=layout),),
            lambda *a: (ES.gat_bwd_dpi_plain(*a),))


def k4_sweep(g) -> list:
    """K4 at every layout (rows per warp, edges in flight per edge group,
    register cap, pj loaded ahead by the lane holding the index or by every
    lane of the group) the library's sweep build holds, at phase 2b's
    shapes, each held to the plain version at RTOL / ATOL before it is
    timed (device ms): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K4_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(30)
    out = []
    log("sweep: K4 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap, pj ahead)")
    for h, d in GATV2_SHAPES:
        out += _forward_sweep(
            "k4", *_k4_as_tuples(ES), _k4_args(ES, g, h, d, gen),
            f"H={h} D={d}",
            [lay + (ahead,) for ahead in (0, 1)
             for lay in _rows_layouts(d // 4)],
            ES._gat_bwd_dpi_layout(d // 4, 16, N, E), ("dpi",))
    return out


def _k12_cases(g, h, d, gen):
    """K12's three cases at (H, D) on ``g``, as phase 2b runs them: node
    values without and with a dropout mask, edge values with one; random
    logits, values and a mask keeping 40 % (scaled by 1 / 0.4)."""
    dev = g.device

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    lg, v = rn(E, h), rn(N, h, d)
    mask = (torch.rand(E, h, generator=gen, device=dev) < 0.4) / 0.4
    ir, cr = g.indptr_r, g.col_r
    return (("node values", (ir, cr, lg, None, v), True),
            ("node values + dropout mask", (ir, cr, lg, mask, v), True),
            ("edge values + dropout mask", (ir, None, lg, mask, rn(E, h, d)),
             False))


def k12_sweep(g) -> list:
    """K12 at every layout (rows per warp, edges in flight per edge group,
    register cap, and at H > 1 the heads one after the other or
    interleaved in the grid, at H = 1 the chosen one) the library's sweep
    build holds, at phase 2b's shapes and cases, each held
    to the plain version at RTOL / ATOL before it is timed (device ms): the
    measurement behind ``ops/cuda/edge_softmax.py``'s ``_K12_*``
    constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(31)
    out = []
    log("sweep: K12 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap, heads interleaved)")
    for h, d in GATV2_SHAPES:
        for label, args, nodes in _k12_cases(g, h, d, gen):
            chosen = ES._edge_softmax_layout(d // 4, 16, N, E, nodes)
            # one head: both orders are the same, so only the chosen one
            orders = (0, 1) if h > 1 else chosen[3:]
            out += _forward_sweep(
                "k12", ES._edge_softmax_kernel, ES.edge_softmax_plain, args,
                f"{label} H={h} D={d}",
                [lay + (interleave,) for interleave in orders
                 for lay in _rows_layouts(d // 4)], chosen,
                ("num", "m", "s"))
            del args
    return out


def _k5_args(ES, g, h, d, gen):
    """K5's arguments at (H, D) on ``g``: random pi, pj, v, dy, and the
    row max, denominator and ``<out, dy>`` of the forward K3 gives."""
    dev, n = g.device, g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    pi, pj, v, dy = rn(n, h), rn(n, h), rn(n, h, d), rn(n, h, d)
    num, m, s = ES.gat_softmax(g.indptr_r, g.col_r, pi, pj, v, 0.2)
    outp, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, d))
    return (g.indptr_s, g.col_s, pi, pj, v, mx, den, (outp * dy).sum(-1), dy,
            0.2)


def k5_sweep(g) -> list:
    """K5 at every layout (rows per warp, edges in flight per edge group,
    register cap, the receivers' scalars packed or not; a packed call's
    time includes its stack) the library's sweep build holds, at phase
    2b's shapes, each held to the plain version at RTOL / ATOL before it
    is timed (device ms): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K5_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(26)
    out = []
    log("sweep: K5 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap, packed scalars)")
    for h, d in GATV2_SHAPES:
        args = _k5_args(ES, g, h, d, gen)
        ref = ES.gat_bwd_rev_plain(*args)
        hd = f"H={h} D={d}"
        chosen = ES._gat_bwd_rev_layout(d // 4, 16, N, E)
        for lay in [lay + (packed,) for packed in (0, 1)
                    for lay in _rows_layouts(d // 4)]:
            got = ES._gat_bwd_rev_kernel(*args, layout=lay)
            err = max(compare(f"K5 {hd} {lay} {nm}", a, b, quiet=True)
                      for nm, a, b in zip(("dpj", "dv"), got, ref))
            row = {"case": hd, "log_rows": lay[0], "unroll": lay[1],
                   "reg_cap": lay[2], "packed": lay[3],
                   "chosen": lay == chosen, "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: ES._gat_bwd_rev_kernel(*args, layout=lay))}
            out.append(row)
            log(f"  K5 {hd:<12} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del args, ref, got
    return out


K8_SWEEP_SHAPES = ((GAT_HEADS, D // GAT_HEADS, D // GAT_HEADS),
                   (1, OUT_D, OUT_D), (1, D, D), (1, 2 * D, 2 * D))


def _k8_args(ES, g, h, o, d, gen):
    """K8's arguments at (H, O, D) on ``g``: random q, k, v, dy, and the
    row max, denominator and ``<out, dy>`` of the forward K6 gives."""
    dev, n = g.device, g.num_nodes

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q, k, v, dy, scale = rn(n, h, o), rn(n, h, o), rn(n, h, d), \
        rn(n, h, d), o ** -0.5
    num, m, s = ES.dot_softmax(g.indptr_r, g.col_r, q, k, v, scale, None)
    outp, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, d))
    return (g.indptr_s, g.col_s, q, k, v, mx, den, (outp * dy).sum(-1), dy,
            scale, None)


def k8_sweep(g) -> list:
    """K8 at every layout (rows per warp, edges in flight per edge group,
    register cap) the library's sweep build holds, at phase 2d's shapes and
    at (1, 256, 256) (two register chunks), each held to the plain version
    at RTOL / ATOL before it is timed (device ms): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K8_*`` constants."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    gen = torch.Generator(device=g.device).manual_seed(13)
    out = []
    log("sweep: K8 layouts (device ms, profiler; log2 rows per warp, edges "
        "in flight, register cap)")
    for h, o, d in K8_SWEEP_SHAPES:
        args = _k8_args(ES, g, h, o, d, gen)
        ref = ES.dot_bwd_rev_plain(*args)
        hd = f"H={h} O={o} D={d}"
        ov = o // 4
        log_g = min((ov - 1).bit_length(), 5)
        nc = 1 << max(0, (ov - 1).bit_length() - 5)
        chosen = ES._dot_bwd_rev_layout(ov, d // 4, N, E)
        for lay in [(log_rows, unroll, cap) for log_rows in range(6 - log_g)
                    for unroll in (1, 2, 4) for cap in (0, 64)
                    if nc * unroll <= 4 or unroll == 1
                    if cap == 0 or nc <= 2]:
            got = ES._dot_bwd_rev_kernel(*args, layout=lay)
            err = max(compare(f"K8 {hd} {lay} {nm}", a, b, quiet=True)
                      for nm, a, b in zip(("dk", "dv"), got, ref))
            row = {"case": hd, "log_rows": lay[0], "unroll": lay[1],
                   "reg_cap": lay[2], "chosen": lay == chosen,
                   "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: ES._dot_bwd_rev_kernel(*args, layout=lay))}
            out.append(row)
            log(f"  K8 {hd:<20} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del args, ref, got
    return out


def _recv_layouts(ov: int, dv: int, vec: bool) -> list:
    """Every K6 and K7 layout of the sweep build: rows (rows per warp, and
    (edges in flight, register cap) as K8's sweep holds them), then strips
    of one 128-byte line (rows per warp, gathers in flight 1-8, uncapped
    and at 64 registers)."""
    wide = max(ov, dv)
    log_g = min((wide - 1).bit_length(), 5)
    nc = 1 << max(0, (wide - 1).bit_length() - 5)
    log_s = 3 if vec else 5
    return ([(0, r, u, cap) for r in range(6 - log_g) for u in (1, 2, 4)
             for cap in (0, 64) if nc * u <= 4 or u == 1
             if cap == 0 or nc <= 2]
            + [(1, r, u, cap) for r in range(6 - log_s)
               for u in (1, 2, 4, 8) for cap in (0, 64)])


def recv_sweep(g) -> list:
    """K6 and K7 at every layout the library's sweep build holds
    (:func:`_recv_layouts`), at phase 2d's shapes and at (1, 256, 256),
    each held to the plain version at RTOL / ATOL before it is timed
    (device ms): K6 writing the raw logits, K7 from them and recomputing
    them. The measurement behind ``ops/cuda/edge_softmax.py``'s
    ``_DOT_*`` constants and the raw-logit residual."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(19)
    out = []
    log("sweep: K6, K7 layouts (device ms, profiler; strips, log2 rows per "
        "warp, edges or gathers in flight, register cap)")
    for h, o, d in K8_SWEEP_SHAPES:
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        q, k, v, dy, scale = rn(N, h, o), rn(N, h, o), rn(N, h, d), \
            rn(N, h, d), o ** -0.5
        raw_ref = torch.empty(E, h, device=dev)
        fwd = (g.indptr_r, g.col_r, q, k, v, scale, None)
        ref6 = ES.dot_softmax_plain(*fwd, raw_ref)
        outp, mx, den = ES.finalize_softmax(*ref6, rn(N, h), rn(N, h, d))
        bwd = (g.indptr_r, g.col_r, q, k, v, mx, den, (outp * dy).sum(-1),
               dy, scale, None)
        ref7 = ES.dot_bwd_dq_plain(*bwd)
        hd = f"H={h} O={o} D={d}"
        ov, dv = o // 4, d // 4
        chosen = ES._dot_recv_layout(ov, dv, 16, N, N, E)
        raw = torch.empty(E, h, device=dev)
        for lay in _recv_layouts(ov, dv, True):
            got = ES._dot_softmax_kernel(*fwd, raw, lay)
            err = max(compare(f"K6 {hd} {lay} {nm}", a, b, quiet=True)
                      for nm, a, b in zip(("num", "m", "s", "raw"),
                                          got + (raw,), ref6 + (raw_ref,)))
            runs = [("k6", True, err, lambda: ES._dot_softmax_kernel(
                *fwd, raw, lay))]
            for given in (raw_ref, None):
                err = compare(f"K7 {hd} {lay} raw={given is not None}",
                              ES._dot_bwd_dq_kernel(*bwd, given, lay), ref7,
                              quiet=True)
                runs.append(("k7", given is not None, err,
                             lambda given=given: ES._dot_bwd_dq_kernel(
                                 *bwd, given, lay)))
            for key, with_raw, err, fn in runs:
                row = {"kernel": key, "case": hd, "strips": lay[0],
                       "log_rows": lay[1], "unroll": lay[2],
                       "reg_cap": lay[3], "raw": with_raw,
                       "chosen": lay == chosen and with_raw,
                       "max_abs_err": err, "device_ms": device_ms(fn)}
                out.append(row)
                log(f"  {key.upper()} {hd:<20} {lay} raw={int(with_raw)} "
                    f"{row['device_ms']:.4f} ms{' (chosen)' * row['chosen']}")
        del q, k, v, dy, raw, raw_ref, ref6, ref7, outp, bwd, fwd
    return out


def rmat_graph(gnn, seed: int = 17):
    """A Graph500 R-MAT graph (Kronecker generator, initiator A, B, C =
    0.57, 0.19, 0.19; vertex labels permuted at random) of 2^17 = N nodes
    and E directed edges, duplicates and self-loops kept as the generator
    makes them: the main path's N and E with a skewed degree distribution
    (power-law tails on both sides) in place of ``rand_graph``'s near-Poisson
    one."""
    rng = np.random.default_rng(seed)
    scale = N.bit_length() - 1
    s = np.zeros(E, np.int64)
    r = np.zeros(E, np.int64)
    for bit in range(scale):
        u = rng.random(E)
        down = u >= 0.57 + 0.19           # quadrant C or D: sender bit set
        right = ((u >= 0.57) & (u < 0.57 + 0.19)) | (u >= 0.57 + 0.19 + 0.19)
        s |= down.astype(np.int64) << bit
        r |= right.astype(np.int64) << bit
    perm = rng.permutation(N)
    return gnn.graph(perm[s], perm[r], num_nodes=N)


def _k8_exact_args(g, h, o, d, gen):
    """K8's arguments at (H, O, D) on ``g`` whose every sum is exact in
    float32: ``k = 0``, ``mx = 0`` and ``den = 1`` make each alpha
    ``exp(0) / 1 = 1``; ``q``, ``v``, ``dy`` in {-1, 0, 1}, ``s_n`` in
    [-2, 2] and ``scale = 0.5`` make each ``dlg`` a half-integer of at most
    ``(D + 2) / 2``, so the sums of rows of fewer than 2^16 edges are
    exact: the kernel at any layout equals the plain version bit for bit,
    hub rows of ~19k edges included. The memory traffic is that of real
    inputs (nothing in K8 branches on values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    q, v, dy = ri(-1, 1, n, h, o), ri(-1, 1, n, h, d), ri(-1, 1, n, h, d)
    k = torch.zeros(n, h, o, device=dev)
    mx, den = torch.zeros(n, h, device=dev), torch.ones(n, h, device=dev)
    return (g.indptr_s, g.col_s, q, k, v, mx, den, ri(-2, 2, n, h), dy, 0.5,
            None)


def _recv_exact_args(g, h, o, d, gen):
    """K6's and K7's arguments at (H, O, D) on ``g`` whose every sum is
    exact in float32: ``q = 0`` makes every raw logit 0 and every weight
    ``exp(0 - 0) = 1``, so K6 sums ``v`` rows of integers in [-8, 8] and
    counts; K7 takes those raw logits with ``mx = 0``, ``den = 1``, ``v``,
    ``dy``, ``k`` in {-1, 0, 1}, ``s_n`` in [-2, 2] and ``scale = 0.5``,
    so each ``dlg`` is a half-integer of at most ``(D + 2) / 2``. Rows of
    fewer than 2^16 edges (R-MAT's hubs of ~19k included) then sum exactly
    in any order. Returns K6's and K7's arguments."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    q, k = torch.zeros(n, h, o, device=dev), ri(-1, 1, n, h, o)
    fwd = (g.indptr_r, g.col_r, q, k, ri(-8, 8, n, h, d), 0.5, None)
    mx, den = torch.zeros(n, h, device=dev), torch.ones(n, h, device=dev)
    bwd = (g.indptr_r, g.col_r, q, k, ri(-1, 1, n, h, d), mx, den,
           ri(-2, 2, n, h), ri(-1, 1, n, h, d), 0.5, None,
           torch.zeros(g.num_edges, h, device=dev))
    return fwd, bwd


def _k11_exact_args(g, h, o, gen):
    """K11's arguments at (H, O) on ``g`` whose every sum is exact in
    float32: ``q[r] = c`` and ``k[s] = -c`` for one ``c`` in {-1, 0, 1}
    per (head, feature) make every ``raw`` 0 (where leaky_relu's slope is
    1) and every logit 0; ``mx = 0`` and ``den = 1`` make each alpha 1;
    ``dy`` and ``a`` in {-1, 0, 1} and ``s_n`` in [-2, 2] make each term of
    ``dk`` an integer of at most ``O + 3``, so rows of fewer than 2^16
    edges sum exactly in any order. The memory traffic is that of real
    inputs (nothing in K11 branches on values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    c = ri(-1, 1, 1, h, o)
    q, k = c.expand(n, h, o).contiguous(), (-c).expand(n, h, o).contiguous()
    mx, den = torch.zeros(n, h, device=dev), torch.ones(n, h, device=dev)
    return (g.indptr_s, g.col_s, q, k, ri(-1, 1, o, h), mx, den,
            ri(-2, 2, n, h), ri(-1, 1, n, h, o), 0.2)


def _k10_exact_args(g, h, o, gen):
    """K10's arguments at (H, O) on ``g`` whose every sum is exact in
    float32: per (head, feature) constants ``q[r] = c1`` in {0, 1} and
    ``k[s] = c2`` in {0, 1}, nonzero in at most 2 features a head, make
    every ``raw = c1 + c2`` in {0, 1, 2} (where leaky_relu's slope is 1)
    and every logit the head's integer ``L = <a, raw>`` for ``a`` in {-1,
    0, 1}; ``mx = L`` and ``den = 1`` make each alpha ``exp(0) / 1 = 1``;
    ``dy`` in {-1, 0, 1} and ``s_n`` in [-2, 2] make each ``dlg`` an
    integer of at most 4, so every term of ``dq`` (``dlg * a``) and of
    ``da`` (``dlg * act``) is an integer of at most 8, and E * 8 < 2^24:
    both sum exactly in any order. The memory traffic is that of real
    inputs (nothing in K10 branches on values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    c1 = ri(0, 1, 1, h, o)
    c2 = torch.zeros(1, h, o, device=dev)
    c2[..., :2] = ri(0, 1, 1, h, min(2, o))
    a = ri(-1, 1, o, h)
    q, k = c1.expand(n, h, o).contiguous(), c2.expand(n, h, o).contiguous()
    mx = ((c1 + c2)[0].t() * a).sum(0).expand(n, h).contiguous()
    den = torch.ones(n, h, device=dev)
    return (g.indptr_r, g.col_r, q, k, a, mx, den, ri(-2, 2, n, h),
            ri(-1, 1, n, h, o), 0.2)


def _k5_exact_args(g, h, d, gen):
    """K5's arguments at (H, D) on ``g`` whose every sum is exact in
    float32: ``pi[r] = c`` and ``pj[s] = -c`` for one ``c`` in {-1, 0, 1}
    per head make every ``raw`` 0 (where leaky_relu's slope is 1) and
    every logit 0; ``mx = 0`` and ``den = 1`` make each alpha 1; ``v`` and
    ``dy`` in {-1, 0, 1} and ``s_n`` in [-2, 2] make each term of ``dv`` an
    integer of at most 1 and of ``dpj`` one of at most ``D + 2``, so rows
    of fewer than 2^16 edges sum exactly in any order. The memory traffic
    is that of real inputs (nothing in K5 branches on values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    c = ri(-1, 1, 1, h)
    pi, pj = c.expand(n, h).contiguous(), (-c).expand(n, h).contiguous()
    mx, den = torch.zeros(n, h, device=dev), torch.ones(n, h, device=dev)
    return (g.indptr_s, g.col_s, pi, pj, ri(-1, 1, n, h, d), mx, den,
            ri(-2, 2, n, h), ri(-1, 1, n, h, d), 0.2)


def _k9_exact_args(g, h, o, gen):
    """K9's arguments at (H, O) on ``g`` whose every sum is exact in
    float32: per (head, feature) constants ``q[r] = c1`` and ``k[s] = c2``
    in {0, 1} with ``a`` in {-1, 0, 1} make every ``raw = c1 + c2`` in {0,
    1, 2} (where leaky_relu's slope is 1) and every logit the head's
    integer ``L = <a, raw>``, so every weight is ``exp(L - L) = 1`` and
    ``num`` is a row's edge count times ``c2``: exact in any order. The
    memory traffic is that of real inputs (nothing in K9 branches on
    values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    c1, c2 = ri(0, 1, 1, h, o), ri(0, 1, 1, h, o)
    q, k = c1.expand(n, h, o).contiguous(), c2.expand(n, h, o).contiguous()
    return g.indptr_r, g.col_r, q, k, ri(-1, 1, o, h), 0.2


def _k3_exact_args(g, h, d, gen):
    """K3's arguments at (H, D) on ``g`` whose every sum is exact in
    float32: ``pi[r] = c`` and ``pj[s] = -c`` for one ``c`` in {-1, 0, 1}
    per head make every logit ``lrelu(0) = 0`` and every weight ``exp(0) =
    1``, so ``s`` counts a row's edges and ``num`` sums ``v`` rows of
    integers in [-8, 8]: rows of fewer than 2^20 edges sum exactly in any
    order. The memory traffic is that of real inputs (nothing in K3
    branches on values)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    c = ri(-1, 1, 1, h)
    pi, pj = c.expand(n, h).contiguous(), (-c).expand(n, h).contiguous()
    return g.indptr_r, g.col_r, pi, pj, ri(-8, 8, n, h, d), 0.2


def _k4_exact_args(g, h, d, gen):
    """K4's arguments at (H, D) on ``g`` whose every sum is exact in
    float32: :func:`_k5_exact_args` over the receiver CSR. Each alpha and
    leaky_relu's slope are 1, so each edge adds an integer of at most ``D +
    2`` to ``dpi``: rows of fewer than 2^16 edges sum exactly in any
    order."""
    return (g.indptr_r, g.col_r) + _k5_exact_args(g, h, d, gen)[2:]


def _k12_exact_args(g, h, d, gen, edge_values=False):
    """K12's arguments at (H, D) on ``g`` whose every sum is exact in
    float32: every edge's logit is its receiver's integer ``c[r]`` in [-2,
    2] (per head), so every weight is ``exp(c - c) = 1``; the mask in {0,
    1, 2} and the node values (or, with ``edge_values``, the edge values)
    integers in [-8, 8] make ``s`` a row's edge count and ``num`` a sum of
    integers of at most 16: rows of fewer than 2^20 edges sum exactly in
    any order. The memory traffic is that of real inputs (K12 branches on
    no value but the running max)."""
    dev, n = g.device, g.num_nodes

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float()

    lg = ri(-2, 2, n, h).index_select(0, g.receivers.long())
    vals = ri(-8, 8, g.num_edges if edge_values else n, h, d)
    return (g.indptr_r, None if edge_values else g.col_r, lg,
            ri(0, 2, g.num_edges, h), vals)


def skew_sweep(gnn, kernels=SWEEPS) -> dict:
    """K1, K8, K6, K7, K2 and K11 on :func:`rmat_graph` at every rows per
    warp, the rest of the layout as the wrappers choose it, K10, K5, K9
    and K3 at one row per warp, each beside the wrapper's own choice (the
    shipped build), each held to the plain version bit for bit on inputs
    whose sums are exact (``_k1_cases(exact=True)``,
    :func:`_k8_exact_args`, :func:`_recv_exact_args`,
    ``_k2_cases(exact=True)``, :func:`_k11_exact_args`,
    :func:`_k10_exact_args`, :func:`_k5_exact_args`,
    :func:`_k9_exact_args`, :func:`_k3_exact_args`; K10, K5, K9 and K3
    twice, the same bits each time):
    whether rows that share a warp lose to one row per warp when a hub
    holds the warp to its longest row. ``kernels``: the names of
    :data:`SWEEPS` to run (K6 and K7 are ``k6_k7``)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    g = rmat_graph(gnn)
    degrees = {}
    for side, ip in (("receiver", g.indptr_r), ("sender", g.indptr_s)):
        lens = torch.diff(ip)
        degrees[side] = {"max": int(lens.max()), "mean": E / N,
                         "empty_rows": int((lens == 0).sum())}
    log(f"sweep: R-MAT graph ({N} nodes, {E} edges; row lengths "
        f"{degrees}), device ms by log2 rows per warp")
    out = {"degrees": degrees, "k1": [], "k8": []}
    for label, args in (_k1_cases(g, 14, exact=True) if "k1" in kernels
                        else ()):
        ref = S.spmm_plain(*args)
        chosen = _k1_chosen(S, args)
        same_bits(f"K1 R-MAT {label} chosen", S._spmm_csr_kernel(*args),
                  ref)
        row = {"case": label, "chosen": chosen,
               "device_ms": device_ms(lambda: S._spmm_csr_kernel(*args)),
               "by_log_rows": {}}
        for log_rows in range(6 - chosen[1]):
            lay = (log_rows,) + chosen[1:]
            same_bits(f"K1 R-MAT {label} {lay}",
                      S._spmm_csr_kernel(*args, layout=lay), ref)
            row["by_log_rows"][log_rows] = device_ms(
                lambda: S._spmm_csr_kernel(*args, layout=lay))
        out["k1"].append(row)
        log(f"  K1 {label:<34} chosen {chosen} {row['device_ms']:.4f} ms; "
            + ", ".join(f"2^{k}: {v:.4f}"
                        for k, v in row["by_log_rows"].items()))
        del ref
    gen = torch.Generator(device=g.device).manual_seed(15)
    for h, o, d in K8_SWEEP_SHAPES[:3] if "k8" in kernels else ():
        args = _k8_exact_args(g, h, o, d, gen)
        ref = ES.dot_bwd_rev_plain(*args)
        hd = f"H={h} O={o} D={d}"
        chosen = ES._dot_bwd_rev_layout(o // 4, d // 4, N, E)
        for nm, a, b in zip(("dk", "dv"), ES._dot_bwd_rev_kernel(*args),
                            ref):
            same_bits(f"K8 R-MAT {hd} chosen {nm}", a, b)
        row = {"case": hd, "chosen": chosen,
               "device_ms": device_ms(lambda: ES._dot_bwd_rev_kernel(*args)),
               "by_log_rows": {}}
        for log_rows in range(6 - min((o // 4 - 1).bit_length(), 5)):
            lay = (log_rows,) + chosen[1:]
            for nm, a, b in zip(("dk", "dv"),
                                ES._dot_bwd_rev_kernel(*args, layout=lay),
                                ref):
                same_bits(f"K8 R-MAT {hd} {lay} {nm}", a, b)
            row["by_log_rows"][log_rows] = device_ms(
                lambda: ES._dot_bwd_rev_kernel(*args, layout=lay))
        out["k8"].append(row)
        log(f"  K8 {hd:<20} chosen {chosen} {row['device_ms']:.4f} ms; "
            + ", ".join(f"2^{k}: {v:.4f}"
                        for k, v in row["by_log_rows"].items()))
        del args, ref
    gen = torch.Generator(device=g.device).manual_seed(16)
    out["k6"], out["k7"] = [], []
    for h, o, d in K8_SWEEP_SHAPES[:3] if "k6_k7" in kernels else ():
        fwd, bwd = _recv_exact_args(g, h, o, d, gen)
        hd = f"H={h} O={o} D={d}"
        chosen = ES._dot_recv_layout(o // 4, d // 4, 16, N, N, E)
        for key, fn, plain, args in (
                ("k6", ES._dot_softmax_kernel, ES.dot_softmax_plain, fwd),
                ("k7", ES._dot_bwd_dq_kernel, ES.dot_bwd_dq_plain, bwd)):
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)

            def check(label, got, ref=ref):
                got = got if isinstance(got, tuple) else (got,)
                for i, (a, b) in enumerate(zip(got, ref)):
                    same_bits(f"{key.upper()} R-MAT {hd} {label} out{i}", a,
                              b)

            check("chosen", fn(*args))
            row = {"case": hd, "chosen": chosen,
                   "device_ms": device_ms(lambda: fn(*args)),
                   "by_log_rows": {}}
            log_g = (3 if chosen[0] else
                     min((max(o, d) // 4 - 1).bit_length(), 5))
            for log_rows in range(6 - log_g):
                lay = (chosen[0], log_rows) + chosen[2:]
                check(str(lay), fn(*args, layout=lay))
                row["by_log_rows"][log_rows] = device_ms(
                    lambda: fn(*args, layout=lay))
            out[key].append(row)
            log(f"  {key.upper()} {hd:<20} chosen {chosen} "
                f"{row['device_ms']:.4f} ms; "
                + ", ".join(f"2^{k}: {v:.4f}"
                            for k, v in row["by_log_rows"].items()))
            del ref
        del fwd, bwd
    out["k2"] = []
    for label, args in (_k2_cases(g, 22, exact=True) if "k2" in kernels
                        else ()):
        ref = S.spmm_sddmm_plain(*args)
        chosen = _k2_chosen(S, args)
        for nm, a, b in zip(("dx", "dw"), S._spmm_sddmm_kernel(*args), ref):
            same_bits(f"K2 R-MAT {label} chosen {nm}", a, b)
        row = {"case": label, "chosen": chosen,
               "device_ms": device_ms(lambda: S._spmm_sddmm_kernel(*args)),
               "by_log_rows": {}}
        for log_rows in range(6 - chosen[1]):
            lay = (log_rows,) + chosen[1:]
            for nm, a, b in zip(("dx", "dw"),
                                S._spmm_sddmm_kernel(*args, layout=lay), ref):
                same_bits(f"K2 R-MAT {label} {lay} {nm}", a, b)
            row["by_log_rows"][log_rows] = device_ms(
                lambda: S._spmm_sddmm_kernel(*args, layout=lay))
        out["k2"].append(row)
        log(f"  K2 {label:<22} chosen {chosen} {row['device_ms']:.4f} ms; "
            + ", ".join(f"2^{k}: {v:.4f}"
                        for k, v in row["by_log_rows"].items()))
        del args, ref
    gen = torch.Generator(device=g.device).manual_seed(24)
    out["k11"] = []
    for h, o in GATV2_SHAPES if "k11" in kernels else ():
        args = _k11_exact_args(g, h, o, gen)
        ref = ES.gatv2_bwd_rev_plain(*args)
        hd = f"H={h} O={o}"
        chosen = ES._gatv2_bwd_rev_layout(o // 4, 16, N, E)
        same_bits(f"K11 R-MAT {hd} chosen", ES._gatv2_bwd_rev_kernel(*args),
                  ref)
        row = {"case": hd, "chosen": chosen,
               "device_ms": device_ms(
                   lambda: ES._gatv2_bwd_rev_kernel(*args)),
               "by_log_rows": {}}
        for log_rows in range(6 - min((o // 4 - 1).bit_length(), 5)):
            lay = (log_rows,) + chosen[1:]
            same_bits(f"K11 R-MAT {hd} {lay}",
                      ES._gatv2_bwd_rev_kernel(*args, layout=lay), ref)
            row["by_log_rows"][log_rows] = device_ms(
                lambda: ES._gatv2_bwd_rev_kernel(*args, layout=lay))
        out["k11"].append(row)
        log(f"  K11 {hd:<12} chosen {chosen} {row['device_ms']:.4f} ms; "
            + ", ".join(f"2^{k}: {v:.4f}"
                        for k, v in row["by_log_rows"].items()))
        del args, ref
    # K10, K5, K9, K3, K4 and K12 at the chosen layout and at one row per
    # warp (the rest of the layout as chosen), each run twice: the same
    # bits as the plain version and as each other
    gen = torch.Generator(device=g.device).manual_seed(27)
    for key in ("k10", "k5", "k9", "k3", "k4", "k12"):
        out[key] = []
    for h, o in GATV2_SHAPES:
        hd = f"H={h} O={o}"
        for key, case, fn, plain, make, chosen in (
                ("k10", hd, ES._gatv2_bwd_dq_kernel, ES.gatv2_bwd_dq_plain,
                 _k10_exact_args, ES._gatv2_bwd_dq_layout(o // 4, 16, N, E)),
                ("k5", hd, ES._gat_bwd_rev_kernel, ES.gat_bwd_rev_plain,
                 _k5_exact_args, ES._gat_bwd_rev_layout(o // 4, 16, N, E)),
                ("k9", hd, ES._gatv2_softmax_kernel, ES.gatv2_softmax_plain,
                 _k9_exact_args, ES._gatv2_softmax_layout(o // 4, 16, N, E)),
                ("k3", hd, ES._gat_softmax_kernel, ES.gat_softmax_plain,
                 _k3_exact_args, ES._gat_softmax_layout(o // 4, 16, N, E)),
                ("k4", hd, *_k4_as_tuples(ES), _k4_exact_args,
                 ES._gat_bwd_dpi_layout(o // 4, 16, N, E)),
                ("k12", f"node values + mask {hd}", ES._edge_softmax_kernel,
                 ES.edge_softmax_plain, _k12_exact_args,
                 ES._edge_softmax_layout(o // 4, 16, N, E, True)),
                ("k12", f"edge values + mask {hd}", ES._edge_softmax_kernel,
                 ES.edge_softmax_plain,
                 functools.partial(_k12_exact_args, edge_values=True),
                 ES._edge_softmax_layout(o // 4, 16, N, E, False))):
            if key not in kernels:
                continue
            args = make(g, h, o, gen)
            ref = plain(*args)
            row = {"case": case, "chosen": chosen, "device_ms": {},
                   "walk_reduce_ms": {}}
            for label, lay in (("chosen", None), ("one row per warp",
                                                  (0,) + chosen[1:])):
                for run in (1, 2):
                    for i, (a, b) in enumerate(zip(fn(*args, layout=lay),
                                                   ref)):
                        same_bits(f"{key.upper()} R-MAT {case} {label} run "
                                  f"{run} out{i}", a, b)
                row["device_ms"][label] = device_ms(
                    lambda: fn(*args, layout=lay))
                if key == "k10":
                    row["walk_reduce_ms"][label] = _split_k10(
                        DEVICE_RECORDS[-1])
            out[key].append(row)
            log(f"  {key.upper()} {case:<12} chosen {chosen} "
                + ", ".join(f"{k}: {v:.4f} ms"
                            for k, v in row["device_ms"].items()))
            del args, ref
    return out


def k14_sweep(g, gb) -> list:
    """The device time of K14 and its backward at every rows per warp the
    width allows, at phase 2f's shapes, each checked against the wrapper's
    own choice first (bit for bit): the measurement behind
    ``ops/cuda/segment.py:_FWD_ENTRIES_PER_GROUP`` and
    ``_BWD_ENTRIES_PER_GROUP``."""
    from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(11)
    out = []
    log("sweep: K14 rows per warp (device ms, profiler)")
    for label, ip, f in (("receiver CSR F=4", g.indptr_r, GAT_HEADS),
                         ("receiver CSR F=8", g.indptr_r, OUT_D),
                         ("receiver CSR F=128", g.indptr_r, D),
                         ("graph CSR F=64", gb.indptr_g, TUD_HIDDEN)):
        n_rows, rows = ip.numel() - 1, int(ip[-1])
        data = torch.randn(rows, f, generator=gen, device=dev)
        dy = torch.randn(n_rows, f, generator=gen, device=dev)
        mx = SG.segment_max_csr(ip, data)
        bwd = SG.segment_max_bwd_csr(ip, data, mx, dy)
        fv = f // 4 if f % 4 == 0 else f
        chosen = [SG._rows_per_warp(fv, n_rows, rows, k) for k in (
            SG._FWD_ENTRIES_PER_GROUP, SG._BWD_ENTRIES_PER_GROUP)]
        for log_rows in range(6 - min((fv - 1).bit_length(), 5)):
            same_bits(f"K14 {label} 2^{log_rows} rows/warp",
                      SG._segment_extreme_kernel(False, ip, data, log_rows),
                      mx)
            same_bits(f"K14 backward {label} 2^{log_rows} rows/warp",
                      SG._segment_max_bwd_kernel(ip, data, mx, dy, log_rows),
                      bwd)
            row = {"case": label, "log_rows": log_rows,
                   "chosen_fwd": log_rows == chosen[0],
                   "chosen_bwd": log_rows == chosen[1],
                   "device_ms": device_ms(lambda: SG._segment_extreme_kernel(
                       False, ip, data, log_rows)),
                   "bwd_device_ms": device_ms(
                       lambda: SG._segment_max_bwd_kernel(ip, data, mx, dy,
                                                          log_rows))}
            out.append(row)
            log(f"  K14 {label:<20} 2^{log_rows} rows/warp fwd "
                f"{row['device_ms']:.4f} ms{' (chosen)' * row['chosen_fwd']} "
                f"bwd {row['bwd_device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen_bwd']}")
        del data, dy, mx, bwd
    return out


def _dot_bf16_layouts(kernel: int, o: int, d: int, vec: int) -> list:
    """Every layout of bfloat16 K6 (``kernel`` 6) or K8 (8) the sweep build
    holds for heads of ``o`` (q, k) and ``d`` (v, dy) values whose rows
    take bf16x8 vectors (``vec`` 16; none for narrower rows), at most 32 of
    them: every rows per warp, the register kernel at (edges in flight,
    register cap) (1, 0), (2, 0), (2, 64), (4, 64), K8 also the staged one
    at (edges a stage, register cap, stages) of {1, 2} x {0, 64} x {2, 4,
    6}; K6 also strips of a 128-byte line at every rows per warp for heads
    wider than a line. K8's tuples are (log_rows, unroll, reg_cap,
    stages), K6's (strips, log_rows, unroll, reg_cap)."""
    wide = -(-max(o, d, 1) // 8)
    if vec != 16 or wide > 32:
        return []
    out, log_g = [], min((wide - 1).bit_length(), 5)
    pairs = ((1, 0), (2, 0), (2, 64), (4, 64))
    for r in range(6 - log_g):
        if kernel == 8:
            out += [(r, u, c, 0) for u, c in pairs]
            out += [(r, u, c, ns) for u in (1, 2) for c in (0, 64)
                    for ns in (2, 4, 6)]
        else:
            out += [(0, r, u, c) for u, c in pairs]
    if kernel == 6 and wide > 8:
        out += [(1, r, 4, 0) for r in range(6 - 3)]
    return out


def dot_kink_allowance(indptr, col, q, k, v, mx, den, s_n, dy, scale,
                       slope, chunk: int = 1 << 19):
    """K8's ``dk`` is discontinuous where leaky_relu's slope jumps (raw =
    0): an edge whose raw logit lies within the float32 rounding of its dot
    (``|raw| <= 32 * 2^-24 * scale * sum |q_i k_i|``; the products of
    bfloat16 values are exact, so only the order of the sum differs) may
    fall on either side in the kernel and in the plain version. Per
    element of ``dk`` over the sender CSR ``(indptr, col)``, float64: what
    such edges may move it by, ``(1 - slope) |alpha (<v, dy> - s_n)
    scale| |q[r]|`` summed over them; with the count of those edges. None
    for the plain dot (no kink)."""
    if slope is None:
        return None, 0
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    rows, recv = ES._filled(indptr, col)
    out = torch.zeros(k.shape, dtype=torch.float64, device=k.device)
    near_n = 0
    for i in range(0, rows.numel(), chunk):
        s_, r_ = rows[i:i + chunk], recv[i:i + chunk]
        qr = q.index_select(0, r_).double()
        prod = qr * k.index_select(0, s_).double()
        raw = scale * prod.sum(-1)
        near = raw.abs() <= 32 * 2.0 ** -24 * scale * prod.abs().sum(-1)
        if not bool(near.any()):
            continue
        near_n += int(near.sum())
        alpha = (torch.exp(torch.where(raw >= 0, raw, slope * raw)
                           - mx.index_select(0, r_).double())
                 / den.index_select(0, r_).double())
        pvd = (v.index_select(0, s_).double()
               * dy.index_select(0, r_).double()).sum(-1)
        t = ((1 - slope) * (alpha * (pvd - s_n.index_select(0, r_).double())
                            * scale).abs() * near)
        out.index_add_(0, s_, t[..., None] * qr.abs())
    return out, near_n


def bf16_dot_sweep(g) -> list:
    """bfloat16 K6 and K8 at every layout :func:`_dot_bf16_layouts` gives,
    at 2h's shapes (:data:`DOT_SHAPES`), each held to the plain version
    (``compare_bf16``: num, dk, dv within one bfloat16 ulp, dk with a
    slope plus :func:`dot_kink_allowance`; m, s and the raw logits at
    RTOL / ATOL) before it is timed (device ms, the packing
    of K8's receiver scalars included): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K6_BF16`` and ``_K8_BF16``. Each row
    says whether the chooser takes the layout (``chosen``) and whether the
    parent's chooser took it (``parent``: the float32 rule, the register
    kernel)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    out = []
    log("sweep: bf16 K6, K8 layouts (device ms, profiler; K6: strips, log2 "
        "rows per warp, edges in flight, register cap; K8: log2 rows per "
        "warp, edges in flight or a stage, register cap, stages)")
    for h, o, d, slope in DOT_SHAPES:
        q, k, v, dy = rn(N, h, o), rn(N, h, o), rn(N, h, d), rn(N, h, d)
        scale = o ** -0.5
        hd = f"H={h} O={o} D={d}" + ("" if slope is None else
                                     f" slope={slope}")
        ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
        raw_ref = torch.empty(E, h, device=dev)
        fwd = (g.indptr_r, g.col_r, q, k, v, scale, slope)
        ref6 = ES.dot_softmax_plain(*fwd, raw_ref)
        outp, mx, den = ES.finalize_softmax(*ref6, rn(N, h), rn(N, h, d))
        bwd = (g.indptr_s, g.col_s, q, k, v, mx, den,
               (outp.float() * dy.float()).sum(-1), dy, scale, slope)
        ref8 = ES.dot_bwd_rev_plain(*bwd)
        kink, near = dot_kink_allowance(*bwd)
        if slope is not None:
            log(f"  K8 bf16 {hd}: {near} edges within their dot's float32 "
                "rounding of the kink (dk held to one ulp plus what they "
                "may move it by)")
        raw = torch.empty(E, h, device=dev)
        cases = (
            (6, ES._dot_recv_layout(ov, dv, vec, N, N, E, 2),
             ES._dot_recv_layout(ov, dv, vec, N, N, E, 2, 7),
             lambda lay: ES._dot_softmax_kernel(*fwd, raw, lay) + (raw,),
             ref6 + (raw_ref,), ("num", "m", "s", "raw")),
            (8, ES._dot_bwd_rev_layout(ov, dv, N, E, vec, 2),
             ES._dot_bwd_rev_layout(ov, dv, N, E) + (0,),
             lambda lay: ES._dot_bwd_rev_kernel(*bwd, layout=lay), ref8,
             ("dk", "dv")))
        for kernel, chosen, parent, run, ref, names in cases:
            for lay in _dot_bf16_layouts(kernel, o, d, vec):
                err = max(compare_bf16(f"K{kernel} bf16 {hd} {lay} {nm}", a,
                                       b, quiet=True,
                                       extra=kink if nm == "dk" else None)
                          for nm, a, b in zip(names, run(lay), ref))
                row = {"kernel": f"K{kernel}", "case": hd,
                       "layout": list(lay), "chosen": lay == chosen,
                       "parent": lay == parent, "max_abs_err": err,
                       "device_ms": device_ms(lambda: run(lay))}
                out.append(row)
                log(f"  K{kernel} bf16 {hd:<24} {lay} "
                    f"{row['device_ms']:.4f} ms"
                    f"{' (chosen)' * row['chosen']}"
                    f"{' (parent)' * row['parent']}")
        del q, k, v, dy, raw, raw_ref, ref6, ref8, outp, fwd, bwd, kink
    return out


# (rows, edges, O = D) of bf16_strip_sweep: the main graph's AGNN width
# (32 MiB of k or v in bf16x8), wider heads on it (48, 66 and 96 MiB) and
# AGNN's width on graphs of 2 and 4 times its rows and edges (64, 128 MiB)
BF16_STRIP_CASES = ((N, E, D), (N, E, 192), (N, E, 264), (N, E, 384),
                    (2 * N, 2 * E, D), (4 * N, 4 * E, D))


def bf16_strip_sweep(gnn, g) -> list:
    """bfloat16 K6 in rows against strips on one-head bf16x8 tables of 32
    to 128 MiB (:data:`BF16_STRIP_CASES`, ``gnn.rand_graph`` beyond the
    main graph ``g``): the chooser's rows and its strips
    (``_dot_softmax_bf16_layout``'s ``strips``), each at its rows per warp
    and one either side, each held to the plain version (num within one
    bfloat16 ulp; m, s, the raw logits at RTOL / ATOL) before it is timed
    (device ms): the measurement behind ``_DOT_BF16_ROWS_BYTES``."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(29)
    out = []
    log("sweep: bf16 K6 rows against strips above 32 MiB (device ms; "
        "strips, log2 rows per warp, edges in flight, register cap)")
    for n, e, o in BF16_STRIP_CASES:
        gg = g if n == N else gnn.rand_graph(n, e, seed=n, device=dev)
        e = gg.num_edges
        q, k, v = (torch.randn(n, 1, o, generator=gen, device=dev).to(bf)
                   for _ in range(3))
        ov, dv, vec = ES._dot_vectors(o, o, q, k, v)
        mib = n * ov * vec / 2**20
        fwd = (gg.indptr_r, gg.col_r, q, k, v, o ** -0.5, None)
        raw_ref, raw = (torch.empty(e, 1, device=dev) for _ in range(2))
        ref = ES.dot_softmax_plain(*fwd, raw_ref) + (raw_ref,)
        chosen = ES._dot_recv_layout(ov, dv, vec, n, n, e, 2)
        lays = []
        for strips in (False, True):
            s_, r0, u, c = ES._dot_softmax_bf16_layout(ov, dv, vec, n, n, e,
                                                       strips)
            top = 5 - (3 if s_ else min((ov - 1).bit_length(), 5))
            lays += [(s_, r, u, c) for r in (r0 - 1, r0, r0 + 1)
                     if 0 <= r <= top]
        hd = f"N={n} H=1 O={o} ({mib:.0f} MiB)"
        for lay in lays:
            got = ES._dot_softmax_kernel(*fwd, raw, lay) + (raw,)
            err = max(compare_bf16(f"K6 bf16 {hd} {lay} {nm}", a, b,
                                   quiet=True)
                      for nm, a, b in zip(("num", "m", "s", "raw"), got, ref))
            row = {"kernel": "K6", "case": hd, "table_mib": mib,
                   "layout": list(lay), "chosen": lay == chosen,
                   "max_abs_err": err,
                   "device_ms": device_ms(
                       lambda: ES._dot_softmax_kernel(*fwd, raw, lay))}
            out.append(row)
            log(f"  K6 bf16 {hd:<32} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")
        del gg, q, k, v, raw, raw_ref, ref, got
    return out


def _k7_bf16_layouts(o: int, d: int, vec: int) -> list:
    """Every layout of bfloat16 K7 ``(strips, log_rows, unroll, reg_cap)``
    the sweep build holds for heads of ``o`` (q, k) and ``d`` (v, dy)
    values on bf16x8 rows (``vec`` 16; none for narrower rows) of at most
    32 vectors: every rows per warp at every (edges in flight, register
    cap) of {1, 2, 4} x {0, 64}; strips of a 128-byte line at every rows
    per warp for heads wider than a line."""
    wide = -(-max(o, d, 1) // 8)
    if vec != 16 or wide > 32:
        return []
    log_g = min((wide - 1).bit_length(), 5)
    out = [(0, r, u, c) for r in range(6 - log_g) for u in (1, 2, 4)
           for c in (0, 64)]
    if wide > 8:
        out += [(1, r, 4, 0) for r in range(6 - 3)]
    return out


def bf16_k7_sweep(g) -> list:
    """bfloat16 K7 at every layout :func:`_k7_bf16_layouts` gives, at 3o's
    shapes (Transformer's (4, 32, 32) and (1, 8, 8), AGNN's (1, 128,
    128)), from K6's raw logits as the main path runs it, each held to the
    plain version (dq within one bfloat16 ulp, :func:`compare_bf16`) before
    it is timed (device ms): the measurement behind
    ``ops/cuda/edge_softmax.py``'s ``_K7_BF16``. Each row says whether the
    chooser takes the layout (``chosen``) and whether the float32 rule that
    bfloat16 K7 took before took it (``parent``)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(31)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    out = []
    log("sweep: bf16 K7 layouts (device ms, profiler; strips, log2 rows per "
        "warp, edges or gathers in flight, register cap)")
    for h, o, d, slope in DOT_SHAPES[:3]:
        q, k, v, dy = rn(N, h, o), rn(N, h, o), rn(N, h, d), rn(N, h, d)
        scale = o ** -0.5
        hd = f"H={h} O={o} D={d}"
        ov, dv, vec = ES._dot_vectors(o, d, q, k, v)
        raw = torch.empty(E, h, device=dev)
        fwd = ES.dot_softmax_plain(g.indptr_r, g.col_r, q, k, v, scale,
                                   slope, raw)
        outp, mx, den = ES.finalize_softmax(*fwd, rn(N, h), rn(N, h, d))
        bwd = (g.indptr_r, g.col_r, q, k, v, mx, den,
               (outp.float() * dy.float()).sum(-1), dy, scale, slope)
        ref = ES.dot_bwd_dq_plain(*bwd, raw)
        chosen = ES._dot_recv_layout(ov, dv, vec, N, N, E, 2, 7)
        parent = ES._dot_recv_layout(ov, dv, vec, N, N, E)
        for lay in _k7_bf16_layouts(o, d, vec):
            err = compare_bf16(f"K7 bf16 {hd} {lay}",
                               ES._dot_bwd_dq_kernel(*bwd, raw, lay), ref,
                               quiet=True)
            row = {"kernel": "K7", "case": hd, "layout": list(lay),
                   "chosen": lay == chosen, "parent": lay == parent,
                   "max_abs_err": err, "device_ms": device_ms(
                       lambda: ES._dot_bwd_dq_kernel(*bwd, raw, lay))}
            out.append(row)
            log(f"  K7 bf16 {hd:<16} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}"
                f"{' (parent)' * row['parent']}")
        del q, k, v, dy, raw, fwd, outp, bwd, ref
    return out


def bf16_k2_sweep(g) -> list:
    """bfloat16 K2 at every layout of the sweep build, at 3o's cases (GCN
    with learned edge weights' D = 128 and 8, GAT (b)'s H = 4, D = 32):
    every strip of a line or more, rows per warp, gathers in flight of {1,
    2, 4, 8} and register cap of {0, 64}, by edge id and by sender-CSR
    position (modes 0, 1), and for several heads the all-heads walk (mode
    2: one group of every head's lanes); each held to the plain version
    (``dx``, ``dw`` within one bfloat16 ulp) before it is timed (device
    ms): the measurement behind ``ops/cuda/spmm.py``'s ``_K2_BF16``,
    ``_K2_BF16_WALK`` and ``_K2_BF16_ROW_BYTES``. ``parent``: the layout
    float32's rule gives, which bfloat16 K2 took before."""
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(37)
    is_, cs, es = g.indptr_s, g.col_s, g.eid_s

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    out = []
    log("sweep: bf16 K2 layouts (device ms, profiler; log2 rows per warp, "
        "log2 strip vectors, gathers in flight, register cap, mode)")
    for h, d in ((1, D), (GAT_HEADS, D // GAT_HEADS), (1, OUT_D)):
        rows = (N, d) if h == 1 else (N, h, d)
        args = (is_, cs, es, rn(*((E,) if h == 1 else (E, h))), rn(*rows),
                rn(*rows))
        fv, vec = S._row_vectors(d, 2, *args[3:])
        log_g = min((fv - 1).bit_length(), 5)
        hd = f"H={h} D={d}"
        chosen = S._spmm_sddmm_bf16_layout(fv, vec, N, N, E, h)
        parent = S._spmm_sddmm_layout(fv, vec, N, N, E, h)
        ref = S.spmm_sddmm_plain(*args)
        lays = [(r, strip, u, c, mode) for mode in (0, 1)
                for strip in range(min(log_g, 3), log_g + 1)
                for r in range(6 - strip) for u in (1, 2, 4, 8)
                for c in (0, 64)]
        if h > 1:
            lg = (h * fv - 1).bit_length()
            lays += [(r, lg, u, c, 2) for r in range(6 - lg)
                     for u in (1, 2, 4, 8) for c in (0, 64)]
        for lay in lays:
            got = S._spmm_sddmm_kernel(*args, layout=lay)
            err = max(compare_bf16(f"K2 bf16 {hd} {lay} {nm}", a, b,
                                   quiet=True)
                      for nm, a, b in zip(("dx", "dw"), got, ref))
            row = {"kernel": "K2", "case": hd, "layout": list(lay),
                   "chosen": lay == chosen, "parent": lay == parent,
                   "max_abs_err": err, "device_ms": device_ms(
                       lambda: S._spmm_sddmm_kernel(*args, layout=lay))}
            out.append(row)
            log(f"  K2 bf16 {hd:<10} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}"
                f"{' (parent)' * row['parent']}")
        del args, ref, got
    return out


def sweep_summary(rows) -> None:
    """Per kernel and case of a sweep's ``rows``: the fastest layout, the
    chosen one's and the parent's device ms."""
    cases = {}
    for r in rows:
        cases.setdefault((r["kernel"], r["case"]), []).append(r)
    for (kernel, case), rs in cases.items():
        best = min(rs, key=lambda r: r["device_ms"])
        pick = {k: next((r for r in rs if r.get(k)), None)
                for k in ("chosen", "parent")}
        log(f"  summary {kernel} {case}: fastest {tuple(best['layout'])} "
            f"{best['device_ms']:.4f} ms; "
            + "; ".join(f"{k} {tuple(r['layout'])} {r['device_ms']:.4f} ms"
                        if r else f"{k} not swept"
                        for k, r in pick.items()))


def bf16_sweep(gnn, g) -> list:
    """The bfloat16 kernels at every layout their instances allow, at 2h's
    shapes, each held to the plain version (one ulp, :func:`compare_bf16`)
    before it is timed (device ms): K1 over the receiver CSR at D = 128 and
    8 and the sender CSR at D = 8 (every rows per warp, strip, gathers in
    flight and register cap of the sweep build); K3, K4 and K5 at (4, 32),
    (1, 8) and (1, 128) at every rows per warp, with and without ``pj``
    ahead (K3, K4) or the packed scalars (K5), at each (edges in flight,
    register cap) of their shipped bfloat16 instances (one register
    chunk); K6 and K8 at every layout of :func:`bf16_dot_sweep`, K6's
    rows against strips (:func:`bf16_strip_sweep`), K7
    (:func:`bf16_k7_sweep`) and K2 (:func:`bf16_k2_sweep`)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES
    from graphneuralnetworks_tpu_torch.ops.cuda import spmm as S

    dev, bf = g.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    out = []

    def sweep(key, label, fn, plain, args, layouts, chosen):
        ref = plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for lay in layouts:
            got = fn(*args, layout=lay)
            got = got if isinstance(got, tuple) else (got,)
            err = max(compare_bf16(f"{key} {label} {lay}", a, b, quiet=True)
                      for a, b in zip(got, ref))
            row = {"kernel": key, "case": label, "layout": list(lay),
                   "chosen": lay == chosen, "max_abs_err": err,
                   "device_ms": device_ms(lambda: fn(*args, layout=lay))}
            out.append(row)
            log(f"  {key} {label:<24} {lay} {row['device_ms']:.4f} ms"
                f"{' (chosen)' * row['chosen']}")

    for label, indptr, col, eid, d in (
            (f"fwd receiver-CSR D={D}", g.indptr_r, g.col_r, None, D),
            (f"fwd receiver-CSR D={OUT_D}", g.indptr_r, g.col_r, None,
             OUT_D),
            (f"bwd sender-CSR D={OUT_D}", g.indptr_s, g.col_s, g.eid_s,
             OUT_D)):
        x = rn(N, d)
        args = (indptr, col, eid, None, x)
        fv, vec = S._row_vectors(d, 2, x, x)
        log_g = min((fv - 1).bit_length(), 5)
        chosen = S._spmm_layout(fv, vec, N, N, E)
        sweep("K1", label, S._spmm_csr_kernel, S.spmm_plain, args,
              [(rows, strip, unroll, cap) for strip in range(log_g + 1)
               for rows in range(6 - strip) for unroll in (1, 2, 4, 8)
               for cap in (0, 64)], chosen)
    ir, cr, is_, cs = g.indptr_r, g.col_r, g.indptr_s, g.col_s
    for h, d in ((GAT_HEADS, D // GAT_HEADS), (1, OUT_D), (1, D)):
        pi, pj, v, dy, sl, sv = (rn(N, h), rn(N, h), rn(N, h, d),
                                 rn(N, h, d), rn(N, h), rn(N, h, d))
        hd = f"H={h} D={d}"
        fv, vec = S._row_vectors(d, 2, v, v)
        log_g = min((fv - 1).bit_length(), 5)
        rows = range(6 - log_g)
        fwd = (ir, cr, pi, pj, v, 0.2)
        sweep("K3", hd, ES._gat_softmax_kernel, ES.gat_softmax_plain, fwd,
              [(r, u, c, a) for r in rows for u, c in ((4, 64), (1, 0))
               for a in (0, 1)],
              ES._gat_softmax_layout(fv, vec, N, E, ES._BF16_MAX_VECTORS))
        out_, mx, den = ES.finalize_softmax(*ES.gat_softmax_plain(*fwd), sl,
                                            sv)
        bwd = (pi, pj, v, mx, den, (out_.float() * dy.float()).sum(-1), dy,
               0.2)
        pairs = ((2, 64), (4, 64))
        sweep("K4", hd, ES._gat_bwd_dpi_kernel, ES.gat_bwd_dpi_plain,
              (ir, cr) + bwd,
              [(r, u, c, a) for r in rows for u, c in pairs for a in (0, 1)],
              ES._gat_bwd_dpi_layout(fv, vec, N, E, ES._BF16_MAX_VECTORS))
        sweep("K5", hd, ES._gat_bwd_rev_kernel, ES.gat_bwd_rev_plain,
              (is_, cs) + bwd,
              [(r, u, c, p) for r in rows for u, c in pairs for p in (0, 1)],
              ES._gat_bwd_rev_layout(fv, vec, N, E, ES._BF16_MAX_VECTORS))
    return (out + bf16_dot_sweep(g) + bf16_strip_sweep(gnn, g)
            + bf16_k7_sweep(g) + bf16_k2_sweep(g))


def tuning_sweep(gnn, g, gb, names=SWEEPS) -> dict:
    """``--sweep``: the sweep build of the ``spmm`` and ``edge_softmax``
    libraries (every instance), then of :data:`SWEEPS` the ``names`` in
    order: :func:`k1_sweep`, :func:`k2_sweep`, :func:`k3_sweep`,
    :func:`k4_sweep`, :func:`k5_sweep`, :func:`recv_sweep` (``k6_k7``),
    :func:`k8_sweep`, :func:`k9_sweep`, :func:`k10_sweep`,
    :func:`k11_sweep`, :func:`k12_sweep`, :func:`k14_sweep` and
    :func:`skew_sweep` (of the named kernels)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import build as B

    t0 = time.perf_counter()
    B.build("spmm", "edge_softmax", sweep=True)
    log(f"sweep build: {time.perf_counter() - t0:.2f} s")
    for name, text in B.build_logs().items():
        if name.endswith("-sweep"):
            log_ptxas(name, text)
    runs = {"k1": lambda: k1_sweep(g), "k2": lambda: {"k2": k2_sweep(g)},
            "k3": lambda: {"k3": k3_sweep(g)},
            "k4": lambda: {"k4": k4_sweep(g)},
            "k12": lambda: {"k12": k12_sweep(g)},
            "k5": lambda: {"k5": k5_sweep(g)},
            "k9": lambda: {"k9": k9_sweep(g)},
            "k6_k7": lambda: {"k6_k7": recv_sweep(g)},
            "k8": lambda: {"k8": k8_sweep(g)},
            "k10": lambda: {"k10": k10_sweep(g)},
            "k11": lambda: {"k11": k11_sweep(g)},
            "skew": lambda: {"skew": skew_sweep(gnn, names)},
            "bf16": lambda: {"bf16": bf16_sweep(gnn, g)},
            "bf16_dot": lambda: {"bf16_dot": bf16_dot_sweep(g)},
            "bf16_strips": lambda: {"bf16_strips": bf16_strip_sweep(gnn, g)},
            "bf16_k7": lambda: {"bf16_k7": bf16_k7_sweep(g)},
            "bf16_k2": lambda: {"bf16_k2": bf16_k2_sweep(g)},
            "k14": lambda: {"k14": k14_sweep(g, gb)}}
    out = {}
    for name in names:
        out.update(runs[name]())
    for name in ("bf16_k7", "bf16_k2"):
        if name in out:
            sweep_summary(out[name])
    log("  clocks.sm,power.draw,temperature.gpu: "
        + smi("clocks.sm,power.draw,temperature.gpu"))
    return out


# ---- phase 3 ---------------------------------------------------------------

# the default ChebConv's K1 launches a call: cheb_lambda_max's 50 power
# iterations and its closing Rayleigh quotient, one SpMM each at D = 1
CHEB_POWER_K1 = 2 * (50 + 1)

def gcn(M, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(M.GCNConv(D, D, torch.relu, generator=gen, device=dev),
                      M.GCNConv(D, OUT_D, generator=gen, device=dev))


def counters():
    """Every kernel's launch counter (module dicts, updated in place)."""
    from graphneuralnetworks_tpu_torch.ops.cuda import (edge_softmax, sddmm,
                                                        segment, spmm)
    return (spmm.launches, edge_softmax.launches, sddmm.launches,
            segment.launches)


def reset_counts() -> None:
    for c in counters():
        c.update(dict.fromkeys(c, 0))


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def train(model, params, step_args, loss_fn, *, steps: int = STEPS,
          eval_loss=None):
    """``steps`` Adam steps with the launch counts of exactly those steps.

    The loss must fall: from the first step's to the last step's, or, with
    ``eval_loss`` (for training with dropout, whose loss moves with its
    masks), from ``eval_loss()`` before the steps to after them.
    """
    from graphneuralnetworks_tpu_torch.training import make_train_step

    opt = torch.optim.Adam(params, lr=1e-3)
    step = make_train_step(model, opt, loss_fn)
    before = float(eval_loss()) if eval_loss is not None else None
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*step_args)
        losses.append(float(loss))     # waits for the step to finish
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = losses[0], losses[-1]
    if eval_loss is not None:
        first, last = before, float(eval_loss())
        log(f"  eval loss (no dropout) {first:.6f} -> {last:.6f}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last} "
                             f"({losses})")
    return losses, times, launches, opt


def expect_counts(name: str, launches: dict, per_step: dict,
                  steps: int = STEPS) -> None:
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want}, got "
                             f"{launches}")


def launched_since(before: dict) -> dict:
    """The launches of each kernel since the counts ``before``, nonzero
    ones only."""
    return {k: c - before[k] for k, c in read_counts().items()
            if c != before[k]}


def expect_launched(name: str, before: dict, want: dict) -> None:
    """The kernels launched since the counts ``before`` are ``want``."""
    launched = launched_since(before)
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, expected {want}")


def compare_model(name, model, g, x, args_fn, extra_params=(),
                  grad_rtol=GRAD_NORM_RTOL, forward=None, zero_grads=()):
    """One forward+backward on the card vs the CPU plain path in float64,
    from the same weights and inputs. ``x`` may be a tuple of inputs, each
    moved to the CPU (a floating one in float64). ``forward(m, g, x, extra)
    -> (out, loss)`` replaces the default: masked cross-entropy of ``m(g,
    x, **args_fn(extra))``; its ``out`` may be a tuple of outputs, each
    compared. The parameters whose names end with one of
    ``zero_grads`` have a gradient that is 0 in exact arithmetic (see
    ZERO_GRAD_FLOOR)."""
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    def node_classes(m, gg, xx, extra):
        logits = m(gg, xx, **args_fn(extra))
        return logits, masked_cross_entropy(logits, gg.nodes["y"],
                                            gg.node_mask)

    def to_cpu(t):
        return t.cpu().double() if t.is_floating_point() else t.cpu()

    forward = forward or node_classes
    cpu_model = copy.deepcopy(model).to("cpu", torch.float64)
    gc = g.to("cpu")
    out = {}
    results = []
    xc = tuple(map(to_cpu, x)) if isinstance(x, tuple) else to_cpu(x)
    for m, gg, xx, extra in ((model, g, x, extra_params),
                             (cpu_model, gc, xc,
                              [p.detach().cpu().double().requires_grad_()
                               for p in extra_params])):
        m.zero_grad(set_to_none=True)
        for p in extra:
            p.grad = None
        logits, loss = forward(m, gg, xx, extra)
        loss.backward()
        grads = [p.grad for p in m.parameters()] + [p.grad for p in extra]
        outs = logits if isinstance(logits, tuple) else (logits,)
        results.append(([o.detach() for o in outs], loss.detach(), grads))
    (lg, ls, gr), (lc, lsc, grc) = results
    out["logits_err"] = max(
        compare(f"{name}: {f'output {i}' if i else 'logits'} card vs CPU",
                a.cpu(), b, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        for i, (a, b) in enumerate(zip(lg, lc)))
    compare(f"{name}: loss card vs CPU", ls.cpu().reshape(1),
            lsc.reshape(1), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    names = [n for n, _ in model.named_parameters()] + [
        f"extra{i}" for i in range(len(extra_params))]
    largest = max(float(b.norm()) for b in grc)
    rels = {nm: float((a.cpu().double() - b).norm()
                      / b.norm().clamp(min=1e-30 if not nm.endswith(
                          zero_grads) else ZERO_GRAD_FLOOR * largest))
            for nm, a, b in zip(names, gr, grc)}
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= grad_rtol
    log(f"  {name}: {len(gr)} gradients card vs CPU, worst "
        f"|a-b|/|b|={rels[worst]:.3e} ({worst}; limit {grad_rtol:g}) "
        f"{'ok' if ok else 'FAIL'}; all: "
        + ", ".join(f"{k} {v:.1e}" for k, v in rels.items()))
    if not ok:
        raise AssertionError(f"{name}: gradient of {worst} differs")
    out["grad_rel_err"] = rels[worst]
    out["grad_rel_errs"] = rels
    return out


def gat(M, seed: int, dev, dropout: float = 0.0):
    """The conv zoo's ``GATConv_h4`` shape with an 8-class head layer."""
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(
        M.GATConv(D, D // GAT_HEADS, torch.relu, heads=GAT_HEADS,
                  dropout=dropout, generator=gen, device=dev),
        M.GATConv(D, OUT_D, heads=1, concat=False, dropout=dropout,
                  generator=gen, device=dev))


def gatv2(M, seed: int, dev):
    """The conv zoo's ``GATv2Conv_h4`` shape with an 8-class head layer."""
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(
        M.GATv2Conv(D, D // GAT_HEADS, torch.relu, heads=GAT_HEADS,
                    generator=gen, device=dev),
        M.GATv2Conv(D, OUT_D, heads=1, concat=False, generator=gen,
                    device=dev))


def transformer(M, seed: int, dev, **kw):
    """The conv zoo's ``TransformerConv_h4`` shape with an 8-class head
    layer; ``kw`` go to both layers."""
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(
        M.TransformerConv(D, D // GAT_HEADS, heads=GAT_HEADS, generator=gen,
                          device=dev, **kw),
        M.TransformerConv(D, OUT_D, heads=1, concat=False, generator=gen,
                          device=dev, **kw))


def agnn(M, seed: int, dev):
    """The conv zoo's ``AGNNConv`` (two of them, between a 128-wide input
    layer and an 8-class head)."""
    torch.manual_seed(seed)
    return M.GNNChain(torch.nn.Linear(D, D, device=dev), torch.relu,
                      M.AGNNConv(device=dev), M.AGNNConv(device=dev),
                      torch.nn.Linear(D, OUT_D, device=dev))


class LinkModel(torch.nn.Module):
    """examples/link_prediction.py's model: a GCN encoder on the message
    graph, ``DotDecoder`` scores on a positive and a negative graph."""

    def __init__(self, M, seed: int, dev):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.enc = M.GNNChain(M.GCNConv(D, D, torch.relu, generator=gen,
                                        device=dev),
                              M.GCNConv(D, D, generator=gen, device=dev))
        self.dec = M.DotDecoder()

    def forward(self, g_msg, pos_g, neg_g, x):
        h = self.enc(g_msg, x)
        self.h = h.detach()    # the encoder's rows: 3o's score scale
        return self.dec(pos_g, h)[:, 0], self.dec(neg_g, h)[:, 0]


def link_loss(pos, neg):
    """Binary cross-entropy of the positive and negative edge scores, with
    log-sigmoid (examples/link_prediction.py:56-60)."""
    return -(torch.nn.functional.logsigmoid(pos).mean()
             + torch.nn.functional.logsigmoid(-neg).mean())


def node_inputs(g):
    """The node-level paths' inputs on ``g``: the graph with labels, the
    features ``x [N, 128]``, the labels and the training mask."""
    dev = g.device
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((N, D)),
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.random.default_rng(4).integers(0, OUT_D, N),
                        device=dev)
    g = g.with_nodes(y=y)
    return g, x, y, g.node_mask


def learned_weights_phase(g, x, y, mask, profile: bool):
    """3b: the GCN of 3a with learned edge weights (K2 in both layers'
    backward); returns its results, the model and the weights."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    log("phase 3b: the same GCN with learned edge weights "
        f"(weighted backward), {STEPS} steps")
    model_w = gcn(M, 1, g.device)
    ew = torch.nn.Parameter(torch.ones(E, device=g.device))

    def loss_w(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x, edge_weight=ew), y, mask)

    res = train_phase("GCN learned edge weights", model_w, (g, x, y, mask),
                      loss_w, {"k1": 2, "k2": 2}, profile,
                      params=list(model_w.parameters()) + [ew])
    return res, model_w, ew


def gat_a_phase(g, x, y, mask, profile: bool):
    """3d: GAT without attention dropout. Per step each layer launches K3
    in the forward and K4 and K5 in the backward. Returns its results and
    the model."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    log(f"phase 3d: GAT train step (GATConv(128,32,relu,heads=4) -> "
        f"GATConv(128,8,heads=1,concat=False), dropout 0), {STEPS} steps")
    model = gat(M, 2, g.device)

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    return train_phase("GAT (a)", model, (g, x, y, mask), loss_fn,
                       {"k3": 2, "k4": 2, "k5": 2}, profile), model


def gat_b_phase(g, x, y, mask, profile: bool):
    """3e: GAT with attention dropout p=0.6 in training mode. Per step each
    layer launches K12 in the forward and K2, once for all its heads, in
    the backward. Returns its results and the model."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    log(f"phase 3e: GAT train step with attention dropout 0.6 "
        f"(deterministic=False), {STEPS} steps")
    model = gat(M, 3, g.device, dropout=0.6)

    def loss_drop(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x, deterministic=False), y, mask)

    def eval_b():
        with torch.no_grad():
            return masked_cross_entropy(model(g, x), y, mask)

    return train_phase("GAT (b)", model, (g, x, y, mask), loss_drop,
                       {"k12": 2, "k2": 2}, profile, eval_loss=eval_b), model


def gatv2_train_phase(g, x, y, mask, profile: bool):
    """3f: GATv2 without attention dropout. Per step each layer launches K9
    in the forward, and K10 (two launches: dq and the blocks' shares of da,
    then their sum) and K11 in the backward. Returns its results and the
    model."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    log(f"phase 3f: GATv2 train step (GATv2Conv(128,32,relu,heads=4) -> "
        f"GATv2Conv(128,8,heads=1,concat=False), dropout 0), {STEPS} steps")
    model = gatv2(M, 4, g.device)

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    return train_phase("GATv2", model, (g, x, y, mask), loss_fn,
                       {"k9": 2, "k10": 4, "k11": 2}, profile), model


def _side(v, dev, dtype=None):
    """A comparison input on ``dev``: a graph moved, a floating tensor also
    cast to ``dtype`` (None: its own), a copy that needs a gradient where
    the original does."""
    if not isinstance(v, torch.Tensor):
        return v.to(dev)
    t = v.detach().to(dev, dtype if v.is_floating_point() else None,
                      copy=True)
    return t.requires_grad_(v.requires_grad)


def _copy_model(model, dev, dtype=None):
    """``model`` copied to ``dev`` (and ``dtype``), without the dropout
    generators the GAT layers hold on the card (the comparison replays the
    card's masks, so the copies draw none)."""
    gens = {m: m._gen for m in model.modules() if hasattr(m, "_gen")}
    for m in gens:
        m._gen = None
    try:
        out = copy.deepcopy(model)
    finally:
        for m, gen in gens.items():
            m._gen = gen
    return out.to(dev, dtype) if dtype is not None else out.to(dev)


class DropoutReplay:
    """Records the dropout masks the GAT layers draw on the card and hands
    the same masks, moved and cast, to the calls that follow ``replay()``
    (the CPU sides of a comparison), in the order they were drawn."""

    def __init__(self):
        from graphneuralnetworks_tpu_torch.models import conv as C
        self.conv, self.real, self.drawn, self.i = C, C._attn_dropout_masks, \
            [], None

    def __enter__(self):
        def masks(p, gen, n_edges, n_dst, heads, with_self, device, dtype):
            if self.i is None:
                out = self.real(p, gen, n_edges, n_dst, heads, with_self,
                                device, dtype)
                self.drawn.append(out)
                return out
            me, ms = self.drawn[self.i]
            self.i += 1
            return (me.to(device, dtype),
                    None if ms is None else ms.to(device, dtype))
        self.conv._attn_dropout_masks = masks
        return self

    def replay(self):
        self.i = 0

    def __exit__(self, *exc):
        self.conv._attn_dropout_masks = self.real


def agnn_beta_scales(m, g, inputs, forward) -> dict:
    """S of each AGNNConv's ``beta`` gradient in the float64 model ``m``
    (names without ``module.``): the same sum as the gradient, taken over
    absolute values. beta enters every logit ``lg = beta <x_n[r], x_n[s]>``
    and self logit, so ``dL/dbeta = sum_e dlg_e lg_e / beta`` (the self
    logits' terms beside), and ``S = sum_e |dlg_e lg_e| / |beta|``, read
    from the logits' gradients at the CPU path's ``attention_aggregate``
    (one call per layer, in order)."""
    from graphneuralnetworks_tpu_torch.ops import attention as TA

    real, sums = TA.attention_aggregate, []

    def spy(gg, logits, values, **kw):
        acc = [0.0]
        for t in (logits, kw.get("self_logits")):
            if t is not None and t.requires_grad:
                t.register_hook(lambda gr, t=t, acc=acc: acc.__setitem__(
                    0, acc[0] + float((gr * t).abs().sum())))
        sums.append(acc)
        return real(gg, logits, values, **kw)
    TA.attention_aggregate = spy
    try:
        m.zero_grad(set_to_none=True)
        forward(m, g, *inputs)[1].backward()
    finally:
        TA.attention_aggregate = real
    betas = [(n, p) for n, p in m.named_parameters() if n.endswith("beta")]
    if len(betas) != len(sums):
        raise AssertionError(f"{len(betas)} betas, {len(sums)} attention "
                             "calls")
    return {n: acc[0] / abs(float(p)) for (n, p), acc in zip(betas, sums)}


def compare_precision_model(name, model, g, inputs, forward, extra=(),
                            out_scale=None, zero_grads=(),
                            grad_scales=None) -> dict:
    """3o's card vs CPU: one forward and backward of the Precision model
    ``model`` (``forward(m, g, *inputs, *extra) -> (out, loss)``, a
    float32 loss of its bfloat16 output) on the card, against the same
    model on the CPU plain path in bfloat16 and, unwrapped, in float64,
    from the same weights, inputs and dropout masks (the card's, replayed);
    ``extra``: float32 parameters beside the model's (learned edge
    weights), whose gradients are compared too. The output is held within
    the tolerances of BF16_CELLS of its scale: max |out| of the float64
    side, or ``out_scale(m)`` of the float64 model after its forward. The
    parameters whose names end with one of ``zero_grads`` have a gradient
    that is 0 in exact arithmetic, held by the largest gradient's norm
    (see BF16_CELLS, the Transformer). ``grad_scales(m, g, inputs,
    forward) -> {name: S}`` gives, from the float64 model, the sum over
    absolute values of a gradient that cancels (AGNN's betas), which holds
    it in place of its norm."""
    rounds, casts = BF16_CELLS[name]
    cpu = torch.device("cpu")
    sides = {"card": (model, g, inputs, extra),
             "CPU bfloat16": (_copy_model(model, cpu), g.to(cpu),
                              [_side(v, cpu) for v in inputs],
                              [_side(e, cpu) for e in extra]),
             "CPU float64": (_copy_model(model.module, cpu, torch.float64),
                             g.to(cpu), [_side(v, cpu, torch.float64)
                                         for v in inputs],
                             [_side(e, cpu, torch.float64) for e in extra])}
    results = {}
    with DropoutReplay() as masks:
        for side, (m, gg, ins, ext) in sides.items():
            if side != "card":
                masks.replay()
            m.zero_grad(set_to_none=True)
            for e in ext:
                e.grad = None
            out, loss = forward(m, gg, *ins, *ext)
            loss.backward()
            results[side] = (out.detach().cpu().double(),
                             loss.detach().cpu().double().reshape(1),
                             [p.grad.cpu().double() for p in
                              list(m.parameters()) + list(ext)])
    scale = (float(out_scale(sides["CPU float64"][0])) if out_scale
             else float(results["CPU float64"][0].abs().max()))
    bad = [n for n, p in model.named_parameters()
           if p.grad.dtype != torch.float32 or not torch.isfinite(
               p.grad).all()]
    if bad:
        raise AssertionError(f"{name} bf16: gradients not finite float32: "
                             f"{bad}")
    names = [n for n, _ in model.named_parameters()] + [
        f"extra{i}" for i in range(len(extra))]
    sums = {}
    if grad_scales is not None:
        m64, g64, ins64, _ = sides["CPU float64"]
        sums = {f"module.{n}": v for n, v in
                grad_scales(m64, g64, ins64, forward).items()}
        g64 = dict(zip(names, results["CPU float64"][2]))
        log(f"  {name} bf16: gradients held by their sums over absolute "
            "values S (|grad| / S in float64): " + ", ".join(
                f"{n} S={v:.3e} ({float(g64[n].norm()) / v:.2e})"
                for n, v in sums.items()))
    lg, ls, gr = results["card"]
    out = {"out_scale": scale, "grad_sums": sums}
    for side, k in (("CPU bfloat16", 2 * rounds),
                    ("CPU float64", rounds + casts)):
        lc, lsc, grc = results[side]
        tol = k * BF16_U
        out[side] = {
            "logits_err": compare(f"{name} bf16: output card vs {side}", lg,
                                  lc, rtol=0, atol=tol * scale),
            "loss_err": compare(f"{name} bf16: loss card vs {side}", ls, lsc,
                                rtol=0, atol=2 * tol * scale)}
        largest = max(float(b.norm()) for b in grc)
        rels = {n: float((a - b).norm() / (
                    sums[n] if n in sums else largest
                    if n.endswith(zero_grads)
                    else b.norm().clamp(min=1e-30)))
                for n, a, b in zip(names, gr, grc)}
        worst = max(rels, key=rels.get)
        limit = BF16_KAPPA.get(name, 1.0) * (
            BF16_U * 2 * (2 * rounds + 1) if side == "CPU bfloat16"
            else BF16_U * (2 * rounds + casts + 1))
        ok = rels[worst] <= limit
        log(f"  {name} bf16: gradients card vs {side}, worst |a-b|/|b|="
            f"{rels[worst]:.3e} ({worst}; limit {limit:.4g}) "
            f"{'ok' if ok else 'FAIL'}; all: "
            + ", ".join(f"{k} {v:.1e}" for k, v in rels.items()))
        if not ok:
            raise AssertionError(f"{name} bf16: gradient of {worst} "
                                 f"differs from {side}")
        out[side]["grad_rel_errs"] = rels
    return out


def precision_phase(g, x, y, mask, profile: bool, gb=None, cells=None,
                    repeat: int = 1):
    """3o: ten paths in ``models.Precision`` (bfloat16 compute, float32
    master parameters), each with its float32 phase's model and graph, 10
    Adam steps on a float32 loss of the bfloat16 output: 3a's GCN (K1's
    bfloat16 variant 3 times a step), 3d's GAT (K3, K4, K5 twice each),
    3f's GATv2 (K9 and K11 twice, K10 four times: walk and reduce), 3g's
    Transformer (K6, K7, K8 twice each, in rows) and 3h's AGNN (the same);
    3b's GCN with learned edge weights (K1 2, K2 2); 3e's GAT (b) with
    attention dropout 0.6 in training mode (K12 2, K2 2); 3i's link step,
    the GCN encoder and ``DotDecoder`` on the 2M edges and 2M negatives
    (K13 2, K1 7); 3j's EdgeConv (K14 2, its backward 2, K1 2 over edge
    rows); 3k's graph classification with ``GlobalPool("max")`` on the
    batch ``gb`` of 4,096 graphs (K1 3, K14 1, its backward 1). Each step
    launches only bfloat16 variants. Each is profiled (ms per step, device
    ms, busy) and one step is held card vs CPU in bfloat16 and in float64
    (:func:`compare_precision_model`, the dropout masks the card's).
    Returns the results and None (the ``--only`` form); ``profile`` is not
    needed, 3o always profiles. ``cells`` (result keys) runs only those
    cells, ``repeat`` times each in turn, without the card-vs-CPU step: a
    measurement of their step times and its spread."""
    from graphneuralnetworks_tpu_torch import models as M, rand_graph
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    del profile
    dev = g.device

    def node_forward(m, gg, xx, *ew, **kw):
        if ew:
            kw["edge_weight"] = ew[0]
        logits = m(gg, xx, **kw)
        wide = logits if logits.dtype == torch.float64 else logits.float()
        return logits, masked_cross_entropy(wide, gg.nodes["y"],
                                            gg.node_mask)

    def dropout_forward(m, gg, xx):
        return node_forward(m, gg, xx, deterministic=False)

    def link_forward(m, gg, neg, xx):
        pos, negs = m(gg, gg, neg, xx)
        wide = torch.float64 if pos.dtype == torch.float64 else torch.float32
        return torch.cat([pos, negs]), link_loss(pos.to(wide),
                                                 negs.to(wide))

    def graph_forward(m, gg, xx):
        logits = m(gg, xx)
        wide = logits if logits.dtype == torch.float64 else logits.float()
        return logits, graph_loss(wide, gg)

    def link_scale(m):
        """max ||h_i||^2 over the encoder's rows: by Cauchy-Schwarz at least
        each score's sum of |h_i h_j|, the scale its errors follow."""
        return float((m.h.double() ** 2).sum(-1).max())

    ew = torch.nn.Parameter(torch.ones(E, device=dev))
    gneg = rand_graph(N, E, seed=2, device=dev)
    table = [
        # name, result key, float32 phase, model, step args, per step,
        # comparison inputs, forward, extra parameters, output scale (the
        # models with a max aggregation: EdgeConv, graph classification)
        ("GCN", "gcn_bf16", "3a", gcn(M, 0, dev), (g, x), {"k1_bf16": 3},
         (x,), node_forward, (), None),
        ("GAT", "gat_bf16", "3d", gat(M, 2, dev), (g, x),
         {"k3_bf16": 2, "k4_bf16": 2, "k5_bf16": 2}, (x,), node_forward, (),
         None),
        ("GATv2", "gatv2_bf16", "3f", gatv2(M, 4, dev), (g, x),
         {"k9_bf16": 2, "k10_bf16": 4, "k11_bf16": 2}, (x,), node_forward,
         (), None),
        ("Transformer", "transformer_bf16", "3g", transformer(M, 5, dev),
         (g, x), {"k6_bf16": 2, "k7_bf16": 2, "k8_bf16": 2}, (x,),
         node_forward, (), None),
        ("AGNN", "agnn_bf16", "3h", agnn(M, 8, dev), (g, x),
         {"k6_bf16": 2, "k7_bf16": 2, "k8_bf16": 2}, (x,), node_forward, (),
         None),
        ("GCN learned edge weights", "gcn_learned_bf16", "3b",
         gcn(M, 1, dev), (g, x), {"k1_bf16": 2, "k2_bf16": 2}, (x,),
         node_forward, (ew,), None),
        ("GAT (b)", "gat_dropout_bf16", "3e", gat(M, 3, dev, dropout=0.6),
         (g, x), {"k12_bf16": 2, "k2_bf16": 2}, (x,), dropout_forward, (),
         None),
        ("link prediction", "link_bf16", "3i", LinkModel(M, 9, dev),
         (g, gneg, x), {"k13_bf16": 2, "k1_bf16": 3 + 4}, (gneg, x),
         link_forward, (), link_scale),
        ("EdgeConv", "edgeconv_bf16", "3j", edgeconv(M, 11, dev), (g, x),
         {"k14_bf16": 2, "k14_bwd_bf16": 2, "k1_bf16": 2}, (x,),
         node_forward, (), None),
        ("graph classification", "graph_classification_bf16", "3k",
         graph_classifier(M, 12, dev, "max"), (gb, gb.x),
         {"k1_bf16": 3, "k14_bf16": 1, "k14_bwd_bf16": 1}, (gb.x,),
         graph_forward, (), None),
    ]
    res = {"vs_cpu": {}}
    if cells is not None:
        table = [c for c in table if c[1] in cells] * repeat

    for n_run, (name, key, base, inner, args, per_step, ins, fwd, extra,
                scale) in enumerate(table):
        log(f"phase 3o: {name} of {base} in bfloat16 (models.Precision, "
            f"float32 master parameters, Adam lr=1e-3), {STEPS} steps")
        model = M.Precision(copy.deepcopy(inner) if cells else inner)
        gg = args[0]

        def loss_fn(m, *a, fwd=fwd, extra=extra):
            return fwd(m, *a, *extra)[1]

        eval_loss = None
        if fwd is dropout_forward:
            def eval_loss(model=model):
                with torch.no_grad():
                    return node_forward(model, g, x)[1]
        res[key if cells is None else f"{key}_{n_run}"] = train_phase(
            f"{name} bf16", model, args, loss_fn, per_step, True,
            params=list(model.parameters()) + list(extra),
            eval_loss=eval_loss)
        if cells is not None:
            del model
            continue
        log(f"phase 3o (3c): one step of the {name} bf16 model on the card "
            "vs the CPU plain path in bfloat16 and in float64")
        res["vs_cpu"][key] = compare_precision_model(
            name, model, gg, ins, fwd, extra, scale,
            zero_grads=("W4.bias",) if name == "Transformer" else (),
            grad_scales=agnn_beta_scales if name == "AGNN" else None)
        del model
    return res, None


def main_path_phase(g, profile: bool, out_dir) -> dict:
    from graphneuralnetworks_tpu_torch import models as M, rand_graph
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    dev = g.device
    g, x, y, mask = node_inputs(g)
    res = {}

    log("phase 3a: GCN train step (GCNConv(128,128,relu) -> GCNConv(128,8), "
        f"masked cross-entropy, Adam lr=1e-3), {STEPS} steps")
    model = gcn(M, 0, dev)

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    res["gcn"] = train_phase("GCN", model, (g, x, y, mask), loss_fn,
                             {"k1": 3}, profile, trace_dir=out_dir)

    res["gcn_learned_edge_weight"], model_w, ew = learned_weights_phase(
        g, x, y, mask, profile)

    log("phase 3c: one forward+backward on the card vs the CPU plain path")
    res["vs_cpu"] = {
        "gcn": compare_model("GCN", model, g, x, lambda extra: {}),
        "gcn_learned_edge_weight": compare_model(
            "GCN learned edge weights", model_w, g, x,
            lambda extra: {"edge_weight": extra[0]}, [ew]),
    }

    res["gat"], model_a = gat_a_phase(g, x, y, mask, profile)
    res["gat_dropout"], _ = gat_b_phase(g, x, y, mask, profile)

    log("phase 3c (GAT): one forward+backward of GAT (a) on the card "
        "(K3-K5) vs the CPU plain path")
    res["vs_cpu"]["gat"] = compare_model("GAT", model_a, g, x,
                                         lambda extra: {})
    log("phase 3c (GAT dropout): GAT (b)'s attention on the card (K12, K2) "
        "vs the CPU plain path, one set of dropout masks")
    res["vs_cpu"]["gat_dropout_attention"] = compare_dropout_attention(
        g, "GAT (b)", "gat_attention",
        ("pi", "pj", "values", "self_logits", "self_values"),
        lambda h, d: [(N, h), (N, h), (N, h, d), (N, h), (N, h, d)])

    res["gatv2"], model_v2 = gatv2_train_phase(g, x, y, mask, profile)
    log("phase 3c (GATv2): one forward+backward of GATv2 (3f) on the card "
        "(K9-K11) vs the CPU plain path")
    res["vs_cpu"]["gatv2"] = compare_model("GATv2", model_v2, g, x,
                                           lambda extra: {},
                                           grad_rtol=GATV2_GRAD_NORM_RTOL)
    log("phase 3c (GATv2 dropout): gatv2_attention with dropout masks on "
        "the card (K12, K2) vs the CPU plain path, one set of masks")
    res["vs_cpu"]["gatv2_dropout_attention"] = compare_dropout_attention(
        g, "GATv2", "gatv2_attention",
        ("q", "k", "a", "self_logits", "self_values"),
        lambda h, d: [(N, h, d), (N, h, d), (d, h), (N, h), (N, h, d)],
        summed=("a",))

    # Transformer: per step each layer launches K6 in the forward, K7 (dq)
    # and K8 (dk, dv) in the backward; q, k and v are projections of a
    # tensor that needs a gradient in both layers
    log(f"phase 3g: Transformer train step (TransformerConv(128,32,heads=4)"
        f" -> TransformerConv(128,8,heads=1,concat=False)), {STEPS} steps")
    model_t = transformer(M, 5, dev)
    res["transformer"] = train_phase("Transformer", model_t, (g, x, y, mask),
                                     loss_fn, {"k6": 2, "k7": 2, "k8": 2},
                                     profile)
    log("phase 3c (Transformer): one forward+backward on the card (K6-K8) "
        "vs the CPU plain path; also with virtual self-loops, and with edge "
        "features (gathered logits, K12 with edge values)")
    res["vs_cpu"]["transformer"] = compare_model(
        "Transformer", model_t, g, x, lambda extra: {},
        zero_grads=("W4.bias",))
    res["vs_cpu"]["transformer_self_loops"] = compare_model(
        "Transformer self-loops", transformer(M, 6, dev, add_self_loops=True),
        g, x, lambda extra: {}, zero_grads=("W4.bias",))
    gen = torch.Generator().manual_seed(7)
    e = torch.nn.Parameter(torch.randn(E, 16, generator=gen).to(dev))
    model_te = M.GNNChain(M.TransformerConv(D, OUT_D, heads=2, concat=False,
                                            edge_features=16, generator=gen,
                                            device=dev))
    before = read_counts()
    res["vs_cpu"]["transformer_edge_features"] = compare_model(
        "Transformer edge features", model_te, g, x,
        lambda extra: {"e": extra[0]}, [e], zero_grads=("W4.bias",))
    expect_launched("Transformer edge features", before, {"k12": 1})
    del e, model_te

    # AGNN: two AGNNConv layers, each K6 forward and K7, K8 backward
    log(f"phase 3h: AGNN train step (Linear(128,128), relu, AGNNConv(), "
        f"AGNNConv(), Linear(128,8)), {STEPS} steps")
    model_ag = agnn(M, 8, dev)
    res["agnn"] = train_phase("AGNN", model_ag, (g, x, y, mask), loss_fn,
                              {"k6": 2, "k7": 2, "k8": 2}, profile)
    log("phase 3c (AGNN): one forward+backward on the card (K6-K8) vs the "
        "CPU plain path")
    res["vs_cpu"]["agnn"] = compare_model("AGNN", model_ag, g, x,
                                          lambda extra: {})

    # Link prediction: the encoder launches K1 in both layers' forwards and
    # in the second layer's backward (the first layer propagates x, which
    # needs no gradient: W comes after the propagation at 128 -> 128): 3.
    # Each DotDecoder launches K13 forward and K1 twice backward (dxi over
    # the receiver CSR, dxj over the sender CSR; x is both): 2 and 4.
    log(f"phase 3i: link-prediction train step (GCN encoder, DotDecoder on "
        f"the {E} edges and on {E} negative edges, binary cross-entropy), "
        f"{STEPS} steps")
    gneg = rand_graph(N, E, seed=2, device=dev)
    model_l = LinkModel(M, 9, dev)

    def loss_link(m, g, gneg, x):
        return link_loss(*m(g, g, gneg, x))

    res["link"] = train_phase("link prediction", model_l, (g, gneg, x),
                              loss_link, {"k13": 2, "k1": 3 + 4}, profile)
    log("phase 3c (link): one forward+backward of the link step on the "
        "card (K1, K13) vs the CPU plain path")
    gneg_cpu = gneg.to("cpu")

    def link_forward(m, gg, xx, extra):
        pos, neg = m(gg, gg, gneg_cpu if xx.device.type == "cpu" else gneg,
                     xx)
        return torch.cat([pos, neg]), link_loss(pos, neg)

    res["vs_cpu"]["link"] = compare_model("link prediction", model_l, g, x,
                                          None, forward=link_forward)
    return res


def zoo_models(M, dev) -> dict:
    """Phase 3l: the conv zoo's propagation rows (benchmarks/zoo_sweep_r5.py:
    44-67, d = 128) as ``GNNChain(L(128, 128), relu, L(128, 8))``, and
    ``GatedGraphConv(128, 2)`` (state width 128) then ``Linear(128, 8)``.
    name -> (model, the call's keywords, trains on ``g.reverse()``, K1
    launches a train step). The input x needs no gradient, so the first
    layer launches K1 in its forward only (GatedGraphConv's and
    ResGatedGraphConv's K1 are their parameters' backward).
    - ChebConv k=3: two hops a layer, their backward in layer 2 (6); the
      default adds its power iteration in each layer (CHEB_POWER_K1);
    - SGConv k=2: two hops a layer, layer 2's backward (6);
    - TAGConv k=3: three hops a layer, layer 2's backward (9);
    - DConv k=2: one hop over g and one over its reverse a layer, layer 2's
      backward (6);
    - ResGatedGraphConv: the backward of the three endpoint gathers (Ax by
      receiver, Bx and Vx by sender) in each layer (6);
    - GatedGraphConv: one SpMM a GRU step, forward and backward (4).
    """
    torch.manual_seed(20)
    gen = torch.Generator().manual_seed(20)
    kw = dict(generator=gen, device=dev)

    def chain(make):
        return M.GNNChain(make(D, D), torch.relu, make(D, OUT_D))

    def cheb():
        return chain(lambda a, b: M.ChebConv(a, b, 3, **kw))

    def dconv():
        return chain(lambda a, b: M.DConv(a, b, 2, **kw))

    return {
        "ChebConv_lam2": (cheb(), {"lambda_max": 2.0}, False, 6),
        "ChebConv": (cheb(), {}, False, 6 + CHEB_POWER_K1),
        "SGConv": (chain(lambda a, b: M.SGConv(a, b, 2, **kw)), {}, False,
                   6),
        "TAGConv": (chain(lambda a, b: M.TAGConv(a, b, 3, **kw)), {}, False,
                    9),
        "DConv": (dconv(), {}, False, 6),
        "DConv_reverse": (dconv(), {}, True, 6),
        "ResGatedGraphConv": (chain(lambda a, b: M.ResGatedGraphConv(
            a, b, **kw)), {}, False, 6),
        "GatedGraphConv": (M.GNNChain(M.GatedGraphConv(D, 2, **kw),
                                      torch.nn.Linear(D, OUT_D, device=dev)),
                           {}, False, 4),
    }


def propagation_phase(g, x, y, mask, profile: bool):
    """3l: each :func:`zoo_models` model trained for STEPS steps with its
    K1 launches asserted, then one forward and backward on the card against
    the CPU plain path in float64 (3c's tolerances) with its launches; also
    DConv on a weighted graph's reverse (K1 reading the weights through
    ``eid_r``). Returns the results and None (the ``--only`` form)."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    res = {"vs_cpu": {}}
    gr = g.reverse()
    for name, (model, call, on_reverse, k1) in zoo_models(M, g.device).items():
        gg = gr if on_reverse else g
        log(f"phase 3l: {name} train step ({'on g.reverse(), ' if on_reverse
                                              else ''}{call or 'defaults'}),"
            f" {STEPS} steps")

        def loss_fn(m, g, x, y, mask, call=call):
            return masked_cross_entropy(m(g, x, **call), y, mask)

        res[name] = train_phase(name, model, (gg, x, y, mask), loss_fn,
                                {"k1": k1}, profile)
        before = read_counts()
        res["vs_cpu"][name] = compare_model(name, model, gg, x,
                                            lambda extra, call=call: call)
        expect_launched(name, before, {"k1": k1})
    log("phase 3c (DConv weighted): DConv on the reverse of the graph with "
        "edge weights, card (K1 by eid_r) vs the CPU plain path")
    gen = torch.Generator(device=g.device).manual_seed(21)
    gw = g.replace(edge_weight=torch.rand(E, generator=gen, device=g.device)
                   + 0.5).reverse()
    before = read_counts()
    res["vs_cpu"]["DConv_weighted_reverse"] = compare_model(
        "DConv weighted reverse", zoo_models(M, g.device)["DConv"][0], gw, x,
        lambda extra: {})
    expect_launched("DConv weighted reverse", before, {"k1": 6})
    return res, None


# 3v: NNConv's per-edge [64, 64] matrices take 8.2 GB a layer at 500,000
# edges, kept for the backward, and their gradient as much again; at E = 2M
# two layers' would pass the card's 80 GB, so its graph is cut to these
NNCONV_E = 500_000
# 3v's card step held to the CPU in float64 on smaller graphs (NNConv's
# float64 matrices at 65,536 edges: 2.1 GB on the host)
EDGE_CHECK_N, EDGE_CHECK_E, NNCONV_CHECK_E = 16_384, 262_144, 65_536
# A float32 pre-activation that lands on the other side of 0 than in
# float64 passes or stops one cotangent g of a relu. At the check's size
# NNConv's two layers hold 2.1M pre-activations (rounding ~5e-7 at a spread
# ~1: ~2 * 5e-7 * 0.4 = 4e-7 of them flip, ~0.8 a check) and its edge
# network 16.8M hidden ones (~1.3 a check); one flip of a layer moves its
# bias gradient by g against a norm of ~|g| sqrt(N / 2 * 64) = 724 |g|
# (terms of random sign): 1.4e-3, and every gradient below it alike (one
# check on an H100 read 1.8e-3, another 7e-7). GMMConv's first layer:
# 262,144 pre-activations, ~0.02 flip a check, 2.8e-3 each. So 3v's relus
# replay the card's masks on the CPU (ReluReplay) and every model keeps
# GRAD_NORM_RTOL; the masks may differ from the CPU's own signs in at most
# RELU_FLIP_SHARE of the elements (25x the 4e-7 above).
RELU_FLIP_SHARE = 1e-5


class ReluReplay:
    """relu that, inside ``with``, keeps the masks ``x > 0`` of its float32
    calls (the card's side of a card-vs-CPU check) and applies them, in
    order, to its float64 calls (the CPU's side: ``x * mask``, relu's value
    and gradient where the signs agree), so that both sides take the same
    side of its kink (see RELU_FLIP_SHARE). Outside ``with`` it is
    ``torch.relu``. A deepcopy is the same object, so a model and its CPU
    copy share it. ``flips`` and ``size`` count the replayed elements whose
    float64 sign differs, and all."""

    def __init__(self):
        self.masks, self.i, self.flips, self.size = None, 0, 0, 0

    def __deepcopy__(self, memo):
        return self

    def __enter__(self):
        self.masks, self.i, self.flips, self.size = [], 0, 0, 0
        return self

    def __exit__(self, *exc):
        masks, self.masks = self.masks, None
        if exc[0] is None and self.i != len(masks):
            raise AssertionError(f"relu replay: {self.i} of {len(masks)} "
                                 "masks replayed")

    def __call__(self, x):
        if self.masks is None:
            return torch.relu(x)
        if x.dtype != torch.float64:
            self.masks.append(x > 0)
            return torch.relu(x)
        mask = self.masks[self.i].to(x.device)
        self.i += 1
        self.flips += int((mask != (x > 0)).sum())
        self.size += mask.numel()
        return x * mask


class EdgeModel(torch.nn.Module):
    """A 3v model: ``pre`` (a Linear from the graph's 128 features, or None
    where the first layer takes them), two edge-featured ``convs`` called
    as ``conv(g, h, side)``, and ``head`` (a Linear to OUT_D, or None).
    ``side`` is the edge features (through ``pre_e`` where given) or, for
    EGNNConv, the positions. A layer that returns a pair (MEGNetConv,
    EGNNConv) hands its second output to the next layer as its side, and
    the model returns the last one beside the logits."""

    def __init__(self, convs, pre=None, pre_e=None, head=None):
        super().__init__()
        self.pre, self.pre_e, self.head = pre, pre_e, head
        self.convs = torch.nn.ModuleList(convs)

    def forward(self, g, x, side):
        h = self.pre(x) if self.pre is not None else x
        s = self.pre_e(side) if self.pre_e is not None else side
        paired = None
        for conv in self.convs:
            out = conv(g, h, s)
            if isinstance(out, tuple):
                h, s = out
                paired = s
            else:
                h = out
        return self.head(h) if self.head is not None else h, paired


def edge_objective(m, g, x, side, y, mask):
    """3v's ``(outputs, loss)`` of the :class:`EdgeModel` ``m`` on ``(g, x,
    side)``: the logits and a paired layer's last edge or position output;
    masked cross-entropy of the logits plus the mean square of the paired
    output, so that every output and every gradient path counts."""
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy

    logits, paired = m(g, x, side)
    loss = masked_cross_entropy(logits, y, mask)
    if paired is None:
        return (logits,), loss
    return (logits, paired), loss + paired.pow(2).mean()


def edge_models(M, dev, relu) -> dict:
    """Phase 3v: each edge-featured layer twice at its published model's
    widths, name -> (model, side input: edge features of that width,
    ``"monet"`` or ``"pos"``, K1 launches a train step); the relus are
    ``relu`` (a :class:`ReluReplay`). K1 is the backward of each endpoint
    gather of a node array that needs a gradient: a layer whose input comes
    from a Linear or a layer gathers it by sender (NNConv, GMMConv's
    ``dense_x(x)``) or by both ends (CGConv, MEGNetConv, and EGNNConv's
    ``h`` and positions, which need none in its first layer).
    - NNConv: MPNN on QM9 (Gilmer et al. 2017; PyG
      ``examples/qm9_nn_conv.py``): width 64, 5 edge features, edge network
      5 -> 128 -> 64 * 64, mean; 1 + 1;
    - CGConv: CGCNN (Xie & Grossman 2018; ``cgcnn`` defaults): atom
      features 64, 41 bond features, softplus, residual; 2 + 2;
    - GMMConv: MoNet on citation graphs (Monti et al. 2017): pseudo-
      coordinates ``(deg(i)^-1/2, deg(j)^-1/2)``, K = 3, hidden 16; 1 + 1;
    - MEGNetConv: MEGNet (Chen et al. 2019; ``megnet`` defaults): block
      units [64, 32], 100 Gaussian bond centres (a Linear to 32), softplus;
      2 + 2;
    - EGNNConv: EGNN on QM9 (Satorras et al. 2021): hidden 128, no edge
      features, 3-D positions; 0 + 4.
    """
    torch.manual_seed(22)
    gen = torch.Generator().manual_seed(22)
    kw = dict(generator=gen, device=dev)
    softplus = torch.nn.functional.softplus

    def lin(a, b):
        return torch.nn.Linear(a, b, device=dev)

    return {
        "NNConv": (EdgeModel(
            [M.NNConv(64, 64, M.MLP([5, 128, 64 * 64], relu, **kw), relu,
                      aggr="mean", **kw) for _ in range(2)],
            pre=lin(D, 64), head=lin(64, OUT_D)), 5, 2),
        "CGConv": (EdgeModel(
            [M.CGConv(64, 64, softplus, edge_features=41, residual=True,
                      **kw) for _ in range(2)],
            pre=lin(D, 64), head=lin(64, OUT_D)), 41, 4),
        "GMMConv": (EdgeModel(
            [M.GMMConv(D, 16, relu, edge_features=2, K=3, **kw),
             M.GMMConv(16, OUT_D, edge_features=2, K=3, **kw)]), "monet", 2),
        "MEGNetConv": (EdgeModel(
            [M.MEGNetConv(phi_e=M.MLP([96, 64, 32], softplus, **kw),
                          phi_v=M.MLP([64, 64, 32], softplus, **kw))
             for _ in range(2)],
            pre=lin(D, 32), pre_e=lin(100, 32), head=lin(32, OUT_D)), 100,
            4),
        "EGNNConv": (EdgeModel(
            [M.EGNNConv(D, D, hidden_size=D, **kw) for _ in range(2)],
            head=lin(D, OUT_D)), "pos", 4),
    }


def edge_side(g, side, seed: int):
    """A 3v model's side input on ``g``, made on the card: positions ``[N,
    3]``, MoNet's degree pseudo-coordinates ``[E, 2]``, or ``[E, side]``
    edge features, normal from ``seed``."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    if side == "pos":
        return torch.randn(g.num_nodes, 3, generator=gen, device=g.device)
    if side == "monet":
        d = torch.diff(g.indptr_r).clamp(min=1).float().rsqrt()
        return torch.stack([d[g.receivers], d[g.senders]], 1)
    return torch.randn(g.num_edges, side, generator=gen, device=g.device)


def edge_layers_phase(g, x, y, mask, profile: bool):
    """3v: each :func:`edge_models` model trained for STEPS steps on the
    main graph (NNConv on ``rand_graph(N, NNCONV_E)``) with its K1 launches
    asserted, profiled (with the ``index_add`` sums of the edge messages),
    its peak memory; then one forward and backward on the card against the
    CPU plain path in float64 (3c's tolerances, every output; the relus'
    masks replayed, see RELU_FLIP_SHARE) on a smaller graph, with its
    launches. Returns the results and None (the ``--only`` form)."""
    import graphneuralnetworks_tpu_torch as gnn
    from graphneuralnetworks_tpu_torch import models as M

    dev = g.device
    res = {"vs_cpu": {}}
    gen = torch.Generator(device=dev).manual_seed(25)
    xs = torch.randn(EDGE_CHECK_N, D, generator=gen, device=dev)
    ys = torch.randint(0, OUT_D, (EDGE_CHECK_N,), generator=gen, device=dev)
    relu = ReluReplay()
    for name, (model, side, k1) in edge_models(M, dev, relu).items():
        nn_conv = name == "NNConv"
        gg = gnn.rand_graph(N, NNCONV_E, seed=3, device=dev) if nn_conv else g
        log(f"phase 3v: {name} train step ({gg.num_edges} edges, side input "
            f"{side}), {STEPS} steps")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res[name] = train_phase(name, model,
                                (gg, x, edge_side(gg, side, 23), y, mask),
                                lambda *a: edge_objective(*a)[1],
                                {"k1": k1}, True)
        res[name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  peak memory {res[name]['peak_gb']:.2f} GB")
        gs = gnn.rand_graph(EDGE_CHECK_N, NNCONV_CHECK_E if nn_conv
                            else EDGE_CHECK_E, seed=4, device=dev)
        log(f"phase 3c ({name}): one forward+backward on "
            f"rand_graph({EDGE_CHECK_N}, {gs.num_edges}), card vs the CPU "
            "plain path in float64")
        before = read_counts()
        with relu:
            res["vs_cpu"][name] = compare_model(
                name, model, gs, (xs, edge_side(gs, side, 24), ys), None,
                forward=lambda m, g_, ins, extra: edge_objective(
                    m, g_, *ins, g_.node_mask))
        expect_launched(name, before, {"k1": k1})
        if relu.size:
            log(f"  relu masks replayed: {relu.flips} of {relu.size} "
                "elements differ from the CPU's own signs")
            res["vs_cpu"][name]["relu_flips"] = relu.flips
            if relu.flips > RELU_FLIP_SHARE * relu.size:
                raise AssertionError(f"{name}: {relu.flips} relu masks of "
                                     f"{relu.size} differ")
        del model, gg, gs
        torch.cuda.empty_cache()
    return res, None


def edgeconv(M, seed: int, dev):
    """The conv zoo's ``EdgeConv(MLP([2d, d]))`` at d=128
    (``benchmarks/zoo_sweep_r5.py:61``), relu, and an 8-class EdgeConv
    head; max aggregation."""
    gen = torch.Generator().manual_seed(seed)
    return M.GNNChain(
        M.EdgeConv(M.MLP([2 * D, D], generator=gen, device=dev)), torch.relu,
        M.EdgeConv(M.MLP([2 * D, OUT_D], generator=gen, device=dev)))


def graph_classifier(M, seed: int, dev, aggr: str, pool=None, width=None):
    """examples/graph_classification.py's model (``:50-55``):
    ``GraphConv(7, 64, relu)``, ``GraphConv(64, 64, relu)``, a pooling
    layer (``GlobalPool(aggr)`` unless ``pool`` is given, of output
    ``width``), ``Linear(., 2)``."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    h = TUD_HIDDEN
    return M.GNNChain(
        M.GraphConv(TUD_FEATURES, h, torch.relu, generator=gen, device=dev),
        M.GraphConv(h, h, torch.relu, generator=gen, device=dev),
        pool if pool is not None else M.GlobalPool(aggr),
        torch.nn.Linear(width or h, 2, device=dev))


def graph_loss(logits, gb):
    """The example's graph-level cross-entropy (``:58-65``)."""
    from graphneuralnetworks_tpu_torch.training import masked_cross_entropy
    return masked_cross_entropy(logits, gb.globals_["y"], gb.graph_mask)


def compare_function(name, fn, g, inputs, want_launches) -> dict:
    """``fn(g, *inputs)`` on the card in float32 and on the CPU plain path
    in float64: the output and every input's gradient at MODEL_RTOL /
    MODEL_ATOL, and the card's launches."""
    gen = torch.Generator(device=g.device).manual_seed(10)
    results = []
    for gg, dt in ((g, torch.float32), (g.to("cpu"), torch.float64)):
        ts = [t.detach().to(gg.device, dt, copy=True).requires_grad_()
              for t in inputs]
        before = read_counts()
        out = fn(gg, *ts)
        if not results:
            cot = torch.randn(out.shape, generator=gen, device=g.device)
        (out * cot.to(gg.device, dt)).sum().backward()
        results.append((out.detach().cpu(), [t.grad.cpu() for t in ts],
                        launched_since(before)))
    (y, grads, launched), (yc, grads_c, launched_c) = results
    if launched != want_launches or launched_c:
        raise AssertionError(f"{name}: launches card {launched} (expected "
                             f"{want_launches}), CPU {launched_c}")
    errs = [compare(f"{name} out", y, yc, rtol=MODEL_RTOL, atol=MODEL_ATOL)]
    errs += [compare(f"{name} d(input {i})", a, b, rtol=MODEL_RTOL,
                     atol=MODEL_ATOL) for i, (a, b) in enumerate(
                         zip(grads, grads_c))]
    return {"max_abs_err": max(errs), "launches": launched}


def graph_path_phase(g, gb, profile: bool, out_dir) -> dict:
    """3j (EdgeConv), 3k (graph classification) and their card-vs-CPU
    checks, with the pooling layers and the graph-wise ops."""
    from graphneuralnetworks_tpu_torch import models as M, ops

    dev = g.device
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((N, D)),
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.random.default_rng(4).integers(0, OUT_D, N),
                        device=dev)
    g = g.with_nodes(y=y)
    mask = g.node_mask
    res = {"vs_cpu": {}}

    def loss_fn(m, g, x, y, mask):
        from graphneuralnetworks_tpu_torch.training import \
            masked_cross_entropy
        return masked_cross_entropy(m(g, x), y, mask)

    # EdgeConv: per step each layer launches K14 forward and backward; the
    # second layer's endpoint gathers (receivers, senders) K1 in backward
    # (the first layer's input needs no gradient)
    log(f"phase 3j: EdgeConv train step (EdgeConv(MLP([256,128])), relu, "
        f"EdgeConv(MLP([256,8])), max aggregation), {STEPS} steps")
    model_ec = edgeconv(M, 11, dev)
    torch.cuda.reset_peak_memory_stats()
    res["edgeconv"] = train_phase("EdgeConv", model_ec, (g, x, y, mask),
                                  loss_fn, {"k14": 2, "k14_bwd": 2, "k1": 2},
                                  profile)
    res["edgeconv"]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory {res['edgeconv']['peak_memory_gb']:.2f} GB")
    log("phase 3c (EdgeConv): one forward+backward on the card (K14, K1) vs "
        "the CPU plain path")
    before = read_counts()
    res["vs_cpu"]["edgeconv"] = compare_model(
        "EdgeConv", model_ec, g, x, lambda extra: {},
        grad_rtol=EDGECONV_GRAD_NORM_RTOL)
    expect_launched("EdgeConv", before, {"k14": 2, "k14_bwd": 2, "k1": 2})
    del model_ec

    # graph classification: K1 in both GraphConv forwards and in the second
    # one's backward; GlobalPool("max") K14 forward and backward over the
    # batch's graph CSR
    log(f"phase 3k: graph classification train step on one batch of "
        f"{gb.num_graphs} graphs ({gb.num_nodes} nodes, {gb.num_edges} "
        f"edges): GraphConv(7,64,relu), GraphConv(64,64,relu), "
        f"GlobalPool(max), Linear(64,2), {STEPS} steps")
    xg = gb.x

    def graph_step_loss(m, gb, x):
        return graph_loss(m(gb, x), gb)

    def graph_forward(m, gg, xx, extra):
        logits = m(gg, xx)
        return logits, graph_loss(logits, gg)

    model_gc = graph_classifier(M, 12, dev, "max")
    res["graph_classification"] = train_phase(
        "graph classification", model_gc, (gb, xg), graph_step_loss,
        {"k1": 3, "k14": 1, "k14_bwd": 1}, profile)
    log("phase 3c (graph classification): one forward+backward on the card "
        "vs the CPU plain path, GlobalPool max and mean")
    for aggr, model, want in (
            ("max", model_gc, {"k1": 3, "k14": 1, "k14_bwd": 1}),
            ("mean", graph_classifier(M, 13, dev, "mean"), {"k1": 3})):
        before = read_counts()
        res["vs_cpu"][f"graph_classification_{aggr}"] = compare_model(
            f"graph classification ({aggr})", model, gb, xg, None,
            forward=graph_forward)
        expect_launched(f"graph classification ({aggr})", before, want)

    log("phase 3c (pooling): GlobalAttentionPool, Set2Set and TopKPool on "
        "the 3k batch, card vs the CPU plain path")
    h = TUD_HIDDEN
    gen = torch.Generator().manual_seed(14)
    xh = torch.randn(gb.num_nodes, h, generator=gen).to(dev)
    torch.manual_seed(14)
    pools = {
        # softmax_nodes' max step: one K14 forward, no backward
        "global_attention_pool": (M.GNNChain(
            M.GlobalAttentionPool(torch.nn.Linear(h, 1, device=dev),
                                  torch.nn.Linear(h, h, device=dev)),
            torch.nn.Linear(h, 2, device=dev)), {"k14": 1}),
        # one softmax_nodes per iteration
        "set2set": (M.GNNChain(M.Set2Set(h, 3, generator=gen, device=dev),
                               torch.nn.Linear(2 * h, 2, device=dev)),
                    {"k14": 3}),
    }
    for name, (model, want) in pools.items():
        before = read_counts()
        # fgate's bias shifts all of a graph's gate logits alike, which the
        # softmax does not see: a gradient of 0 (ZERO_GRAD_FLOOR)
        res["vs_cpu"][name] = compare_model(name, model, gb, xh, None,
                                            forward=graph_forward,
                                            zero_grads=("fgate.bias",))
        expect_launched(name, before, want)
    # TopKPool keeps the 1024 best of ~78k continuous scores: at a float32
    # rounding of ~1e-7 against gaps of ~1e-4 near the k-th score, two
    # neighbours swap ranks now and then, so the rows are compared in node
    # order and the loss does not depend on the order; the kept set must
    # agree
    topk = M.TopKPool(h, 1024, generator=gen, device=dev)
    w_topk = torch.randn(h, generator=gen).to(dev)
    kept = []

    def topk_forward(m, gg, xx, extra):
        out, idx = m(gg, xx)
        order = torch.argsort(idx)
        kept.append(idx[order].cpu())
        return out[order], ((out @ w_topk.to(out)) ** 2).sum()

    res["vs_cpu"]["topk_pool"] = compare_model("TopKPool", topk, gb, xh,
                                               None, forward=topk_forward)
    if not torch.equal(kept[0], kept[1]):
        raise AssertionError("TopKPool: the card and the CPU keep other "
                             "nodes")

    log("phase 3c (softmax_edge_neighbors, GraphConv max): on the main graph, "
        "card vs the CPU plain path")
    lg = torch.randn(E, GAT_HEADS, generator=gen).to(dev)
    res["vs_cpu"]["softmax_edge_neighbors"] = compare_function(
        f"softmax_edge_neighbors H={GAT_HEADS}", ops.softmax_edge_neighbors,
        g, [lg], {"k14": 1})
    before = read_counts()
    # the messages are x_j themselves, equal on both sides: the same maxima;
    # x needs no gradient, so the max has no backward here (3j runs it)
    res["vs_cpu"]["graphconv_max"] = compare_model(
        "GraphConv(aggr=max)", M.GNNChain(M.GraphConv(
            D, OUT_D, aggr="max", generator=gen, device=dev)), g, x,
        lambda extra: {})
    expect_launched("GraphConv(aggr=max)", before, {"k14": 1})
    return res


def train_phase(name, model, args, loss_fn, per_step, profile, *,
                params=None, eval_loss=None, trace_dir=None) -> dict:
    """:func:`train` of ``params`` (default: the model's), its log lines,
    the launch counts checked against ``per_step`` and, with ``profile``, a
    :func:`profile_steps` breakdown (its trace written to ``trace_dir``)."""
    losses, times, launches, _ = train(
        model, model.parameters() if params is None else params, args,
        loss_fn, eval_loss=eval_loss)
    log(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f}; ms/step "
        f"median={statistics.median(times):.3f} "
        f"first={times[0]:.3f} all={[round(t, 3) for t in times]}")
    log(f"  launches over {STEPS} steps: {launches}")
    expect_counts(name, launches, per_step)
    out = {"losses": losses, "ms_per_step": times,
           "median_ms_per_step": statistics.median(times),
           "launches": launches}
    if profile:
        out["profile"] = profile_steps(model, args, loss_fn, trace_dir,
                                       params)
    return out


def compare_dropout_attention(g, label, fn_name, names, shapes,
                              summed=()) -> dict:
    """``ops.attention.<fn_name>(g, x0, x1, x2, 0.2, self_logits=x3,
    self_values=x4, dropout_masks=...)`` on the card and on the CPU with the
    same inputs and masks: the forward and the gradient of every input, at
    both layers' (H, D); ``shapes(h, d)`` gives the five inputs' shapes.
    The card side must launch K12 once and K2 once, for all heads. The
    gradients of the inputs in ``summed`` (GATv2's ``a``) sum one term per
    edge, as a weight gradient does, and are compared by norm
    (GRAD_NORM_RTOL)."""
    from graphneuralnetworks_tpu_torch.ops import attention

    fn = getattr(attention, fn_name)
    dev, gc = g.device, g.to("cpu")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for h, d in ((GAT_HEADS, D // GAT_HEADS), (1, OUT_D)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        ins = [rn(*s) for s in shapes(h, d)]
        masks = [(torch.rand(rows, h, generator=gen, device=dev) < 0.4) / 0.4
                 for rows in (E, N)]
        cot = rn(N, h, d)
        results = []
        for gg in (g, gc):
            dv = gg.device
            ts = [t.detach().to(dv, copy=True).requires_grad_() for t in ins]
            before = read_counts()
            y = fn(gg, ts[0], ts[1], ts[2], 0.2, self_logits=ts[3],
                   self_values=ts[4],
                   dropout_masks=tuple(m.to(dv) for m in masks))
            (y * cot.to(dv)).sum().backward()
            launched = launched_since(before)
            results.append((y.detach().cpu(), [t.grad.cpu() for t in ts],
                            launched))
        (y, grads, launched), (yc, grads_c, launched_c) = results
        if launched != {"k12": 1, "k2": 1} or launched_c:
            raise AssertionError(f"{label} dropout attention H={h}: "
                                 f"launches card {launched}, CPU "
                                 f"{launched_c}")
        hd = f"H={h} D={d}"
        errs = [compare(f"{label} attention {hd} out", y, yc,
                        rtol=MODEL_RTOL, atol=MODEL_ATOL)]
        for nm, a, b in zip(names, grads, grads_c):
            if nm not in summed:
                errs.append(compare(f"{label} attention {hd} d{nm}", a, b,
                                    rtol=MODEL_RTOL, atol=MODEL_ATOL))
                continue
            rel = float((a.double() - b.double()).norm()
                        / b.double().norm().clamp(min=1e-30))
            log(f"  {label} attention {hd} d{nm}: |a-b|/|b|={rel:.3e} "
                f"(limit {GRAD_NORM_RTOL:g}) "
                f"{'ok' if rel <= GRAD_NORM_RTOL else 'FAIL'}")
            if not rel <= GRAD_NORM_RTOL:
                raise AssertionError(f"{label} attention {hd} d{nm} "
                                     "differs")
        out[hd] = {"max_abs_err": max(errs), "launches": launched}
        del ins, masks, results, y, grads, yc, grads_c
    return out


# The device kernels of the hand-written kernels whose time a profiled step
# reports on its own (by the kernels' names in csrc/): K2 launches a pass
# before and after its sweep, K6 and K7 several passes in strips, told
# apart by the template argument 6 or 7, K10 its da reduce after its walk.
STEP_KERNELS = {
    "k1": ("spmm_csr_kernel<",),
    "k2": ("spmm_sddmm_csr_kernel<", "spmm_sddmm_weights_kernel",
           "spmm_sddmm_sum_kernel", "spmm_sddmm_heads_kernel<"),
    "k6": ("dot_softmax_rows_kernel<", "dot_strip_dots_kernel<6,", "dot_strip_stats_kernel<6>",
           "dot_strip_spmm_kernel<6,"),
    "k7": ("dot_bwd_dq_rows_kernel<", "dot_strip_dots_kernel<7,",
           "dot_strip_stats_kernel<7>", "dot_strip_spmm_kernel<7,"),
    "k8": ("dot_bwd_rev_kernel<", "dot_bwd_rev_staged_kernel<"),
    "k11": ("gatv2_bwd_rev_kernel<",),
    "k10": ("gatv2_bwd_dq_kernel<", "gatv2_da_reduce_kernel"),
    "k5": ("gat_bwd_rev_kernel<",),
    "k9": ("gatv2_softmax_rows_kernel<",),
    "k3": ("gat_softmax_rows_kernel<",),
    "k4": ("gat_bwd_dpi_rows_kernel<",),
    "k12": ("edge_softmax_rows_kernel<",),
}


def op_sites(step) -> list:
    """``(device ms, calls, op, site)`` of one profiled ``step()``: the
    device time of the kernels each outermost aten op launched (the ops
    inside it counted with it), summed by op, first input's shape and call
    site, largest first. The site is the backward function that ran the op
    (``in <name>``), if any, and the two innermost frames in the port's
    package of its Python stack (the stacks of ops that the autograd
    engine runs may lag behind; the backward function names them)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    # verbose: the events keep their Python stacks
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  with_stack=True, record_shapes=True,
                  experimental_config=torch._C._profiler._ExperimentalConfig(
                      verbose=True)) as prof:
        step()
        torch.cuda.synchronize()
    sums = {}
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA") or ev.device_time_total <= 0:
            continue
        parent = ev.cpu_parent
        if not ev.name.startswith("aten::") or (
                parent is not None and parent.name.startswith("aten::")):
            continue
        while parent is not None and not parent.name.startswith(
                "autograd::engine::evaluate_function: "):
            parent = parent.cpu_parent
        where = (() if parent is None else
                 (f"in {parent.name.split(': ', 1)[1]}",)) + tuple(
            f.split("graphneuralnetworks_tpu_torch/")[-1]
            for f in (ev.stack or [])
            if "graphneuralnetworks_tpu_torch" in f)[:2]
        shape = list(ev.input_shapes[0]) if ev.input_shapes else []
        key = (f"{ev.name} {shape}", where)
        ms, n = sums.get(key, (0.0, 0))
        sums[key] = (ms + ev.device_time_total / 1e3, n + 1)
    return sorted(((ms, n, name, list(where))
                   for (name, where), (ms, n) in sums.items()), reverse=True)


def op_device_ms(prof, names, steps: int) -> float:
    """The device ms a step of the kernels launched inside the aten ops
    ``names`` (by the outermost of them, so that one nested in another
    counts once; ``index_select``'s backward runs ``index_add_``)."""
    total = 0.0
    for ev in prof.events():
        if ev.name not in names or str(ev.device_type).endswith("CUDA"):
            continue
        parent = ev.cpu_parent
        while parent is not None and parent.name not in names:
            parent = parent.cpu_parent
        if parent is None:
            total += ev.device_time_total
    return total / 1e3 / steps


def profile_steps(model, args, loss_fn, out_dir, params=None) -> dict:
    from graphneuralnetworks_tpu_torch.training import make_train_step

    opt = torch.optim.Adam(model.parameters() if params is None else params,
                           lr=1e-3)
    step = make_train_step(model, opt, loss_fn)
    return profile_calls(lambda: step(*args), out_dir)


def profile_calls(step, out_dir) -> dict:
    """A ``torch.profiler`` breakdown of three calls of ``step()`` (after
    one unprofiled): wall and device ms per call, the busy share, aten op
    calls on the host, the time of each kernel of :data:`STEP_KERNELS`, the
    top kernels and host ops, and the device time by op and call site
    (:func:`op_sites`, one more call)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, 3)
    host = sorted(((ev.self_cpu_time_total / 1e3 / 3, ev.count // 3, ev.key)
                   for ev in prof.key_averages()
                   if not str(ev.device_type).endswith("CUDA")
                   and ev.key.startswith("aten::")), reverse=True)
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in host)
    index_add = op_device_ms(prof, ("aten::index_add", "aten::index_add_"),
                             3)
    kernels = {k: sum(ms for ms, _, key in rows
                      if any(p in key for p in pats))
               for k, pats in STEP_KERNELS.items()}
    kernels = {k: v for k, v in kernels.items() if v > 0}
    launches = {k: launch_ms(prof, STEP_KERNELS[k], 3) for k in kernels}
    log(f"  profile (3 steps): wall {wall / 3:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step ({100 * busy / (wall / 3):.1f}%), "
        f"{n_ops} aten op calls/step on the host (nested counted); "
        + ", ".join(f"{k.upper()} {v:.4f} ms/step ({100 * v / busy:.1f}%)"
                    for k, v in kernels.items())
        + f"; index_add {index_add:.4f} ms/step "
          f"({100 * index_add / max(busy, 1e-12):.1f}%)")
    for k, v in launches.items():
        log(f"    {k.upper()} per launch, in step order: "
            + (", ".join(f"{ms:.4f}" for ms in v) + " ms" if v else
               "not split (the profiler lost a record)"))
    for ms, cnt, key in rows[:20]:
        log(f"    {ms:9.4f} ms/step  x{cnt:<4} {key[:90]}")
    log("    host self time (profiled), top aten ops: " + ", ".join(
        f"{key} x{cnt} {ms:.3f} ms" for ms, cnt, key in host[:8]))
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    sites = op_sites(step)
    log("    device time by op and call site (one step, nested ops "
        "counted in each): " + "; ".join(
            f"{key} x{cnt} {ms:.3f} ms at {' < '.join(where) or '-'}"
            for ms, cnt, key, where in sites[:12]))
    return {"wall_ms_per_step": wall / 3, "device_ms_per_step": busy,
            "aten_ops_per_step": n_ops, "kernel_ms_per_step": kernels,
            "index_add_ms_per_step": index_add,
            "kernel_ms_per_launch": launches,
            "sites": [{"ms": ms, "calls": c, "op": k, "at": w}
                      for ms, c, k, w in sites[:30]],
            "top": [{"ms_per_step": ms, "calls_per_step": c, "name": k}
                    for ms, c, k in rows[:30]],
            "host_top": [{"self_cpu_ms_per_step": ms, "calls_per_step": c,
                          "name": k} for ms, c, k in host[:30]]}


# ---- phases 2l, 3w and 3x: the receiver-order kernels over CSR views ------

# 3w: GAT at the widths of PyG's examples/ogbn_products_gat.py (hidden 128,
# 4 heads; its 3 hops cut to 3n's 2), its last layer's heads averaged
GAT_OGB_HIDDEN, GAT_OGB_HEADS = 128, 4
# 3q (extended): TGCN over three snapshots of unequal node and edge counts,
# padded by from_snapshots(uniform=True): nodes and 16 edges a node
TQ_NODES = (16_384, 14_336, 12_288)


def view_edges(g):
    """The ids of the edges of ``g`` that count (every edge, or those of
    ``edge_valid``) and their receivers and senders (int64), read from the
    graph's own edge order: the index arrays of 2l's references, which use
    no CSR."""
    ids = (torch.arange(g.num_edges, device=g.device)
           if g.edge_valid is None else torch.nonzero(g.edge_valid)[:, 0])
    return ids, g.receivers.index_select(0, ids), g.senders.index_select(
        0, ids)


def view_refs(g):
    """Plain PyTorch references of K3-K12 over the receiver and sender ids
    of the edges that count (segment ops over ids, no CSR): each returns
    what its kernel returns. Edge arrays come in edge order."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES
    from graphneuralnetworks_tpu_torch.ops.cuda.spmm import _work_dtype

    ids, r, s = view_edges(g)
    n = g.num_nodes

    def sums(lg, mask, v_e, dtype):
        num, m, s_ = ES._softmax_sums(r, n, lg, mask, v_e)
        return num.to(dtype), m, s_

    def into(rows, shape, vals, dtype):
        return vals.new_zeros(shape).index_add_(0, rows, vals).to(dtype)

    def k3(pi, pj, v, slope):
        w = _work_dtype(v.dtype)
        lg = ES.lrelu(pi.index_select(0, r).to(w)
                      + pj.index_select(0, s).to(w), slope)
        return sums(lg, None, v.index_select(0, s).to(w), v.dtype)

    def k4(pi, pj, v, mx, den, s_n, dy, slope):
        dlg = ES._gat_edge_terms(r, s, pi, pj, v, mx, den, s_n, dy, slope)[2]
        return into(r, pi.shape, dlg, pi.dtype)

    def k5(pi, pj, v, mx, den, s_n, dy, slope):
        alpha, dy_e, dlg = ES._gat_edge_terms(r, s, pi, pj, v, mx, den, s_n,
                                              dy, slope)
        return (into(s, pj.shape, dlg, pj.dtype),
                into(s, v.shape, alpha[..., None] * dy_e, v.dtype))

    def k12(logits, mask, v):
        return sums(logits.index_select(0, ids), mask.index_select(0, ids),
                    v.index_select(0, s), v.dtype)

    def k9(q, k, a, slope):
        k_e, _, _, lg = ES._gatv2_logits(r, s, q, k, a, slope)
        return sums(lg, None, k_e, k.dtype)

    def k10(q, k, a, mx, den, s_n, dy, slope):
        _, _, act, dlg, draw = ES._gatv2_edge_terms(r, s, q, k, a, mx, den,
                                                    s_n, dy, slope)
        return (into(r, q.shape, draw, q.dtype),
                torch.einsum("ehf,eh->fh", act, dlg))

    def k11(q, k, a, mx, den, s_n, dy, slope):
        alpha, dy_e, _, _, draw = ES._gatv2_edge_terms(r, s, q, k, a, mx, den,
                                                       s_n, dy, slope)
        return into(s, k.shape, draw + alpha[..., None] * dy_e, k.dtype)

    def k6(q, k, v, scale, slope):
        _, lg = ES._dot_logits(r, s, q, k, scale, slope)
        return sums(lg, None, v.index_select(0, s), v.dtype)

    def k7(q, k, v, mx, den, s_n, dy, scale, slope):
        dlg = ES._dot_edge_terms(r, s, q, k, v, mx, den, s_n, dy, scale,
                                 slope)[2]
        return into(r, q.shape, dlg[..., None] * k.index_select(0, s), q.dtype)

    def k8(q, k, v, mx, den, s_n, dy, scale, slope):
        alpha, dy_e, dlg = ES._dot_edge_terms(r, s, q, k, v, mx, den, s_n,
                                              dy, scale, slope)
        return (into(s, k.shape, dlg[..., None] * q.index_select(0, r),
                     k.dtype),
                into(s, v.shape, alpha[..., None] * dy_e, v.dtype))

    return dict(k3=k3, k4=k4, k5=k5, k12=k12, k9=k9, k10=k10, k11=k11, k6=k6,
                k7=k7, k8=k8)


def view_case(res, card, key, label, run, ref, byt, flops, checks=None,
              lib=None, out=None, again=0):
    """Hold ``out(run())`` (default ``run()``: a kernel over a CSR view) to
    ``ref()`` (the plain computation over receiver ids), time both and
    ``lib()`` where given (:func:`timings`), bound it (:func:`bound`) and
    add the case to ``res[key]``; returns ``run()``. ``checks``: per output,
    its name and tolerance (default RTOL / ATOL; None: the same bits,
    :func:`same_bits`). ``again``: the bytes the per-edge gathers read
    again when L2 keeps nothing (the no-reuse bound)."""
    got = run()
    mapped = got if out is None else out(got)
    mapped = mapped if isinstance(mapped, tuple) else (mapped,)
    want = ref()
    want = want if isinstance(want, tuple) else (want,)
    checks = checks or [(f"out{i}", {}) for i in range(len(want))]
    err = 0.0
    for (name, tol), a, b in zip(checks, mapped, want):
        if tol is None:
            same_bits(f"{key.upper()} {label} {name}", a, b)
        else:
            # rows without entries: -inf in both (the softmax state), then
            # the finite values within the tolerance
            a, b = a.float(), b.float()
            inf = torch.isinf(b)
            if not torch.equal(torch.isinf(a), inf) or not torch.equal(
                    a[inf], b[inf]):
                raise AssertionError(f"{key.upper()} {label} {name}: "
                                     "infinities differ")
            err = max(err, compare(f"{key.upper()} {label} {name}",
                                   a.masked_fill(inf, 0),
                                   b.masked_fill(inf, 0), **tol))
    res.setdefault(key, {"err": 0.0, "variants": []})
    res[key]["err"] = max(res[key]["err"], err)
    b_ms, b_by = bound(byt, flops, card)
    res[key]["variants"].append({
        "case": label, **timings(run, ref, lib, device_required=False),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "no_reuse_bound_ms": (byt + again) / peaks(card)[0] * 1e3,
        "max_abs_err": err})
    return got


def view_kernel_cases(res, card, g, name, shapes) -> dict:
    """Phase 2l's cases over the CSR view of ``g`` (``graph.csr_view``: a
    reversed graph's groupings through their edge-id maps, or a sampled
    graph's CSRs compacted to its valid edges), each held to the plain
    computation over the receiver and sender ids of the edges that count
    (:func:`view_refs`), not to the kernel's plain version over the same
    view, so that the view's mapping is checked too. ``shapes``: the
    attention ``(H, D)``, GATv2 ``(H, O)``, dot ``(H, O, D)``, K13 ``(H,
    D)`` and K14 widths. Returns the view's build time (device ms)."""
    from graphneuralnetworks_tpu_torch.graph import csr_view
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES
    from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD
    from graphneuralnetworks_tpu_torch.ops.cuda import segment as SG
    from graphneuralnetworks_tpu_torch.ops import segment as OS

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(23)
    # a reversed graph's view is its own groupings: nothing to build
    build_ms = (device_ms(lambda: csr_view(g.replace()), calls=5)
                if g.edge_valid is not None else 0.0)
    v = csr_view(g)
    n, e = g.num_nodes, g.num_edges
    ent = int(v.indptr_r[-1])
    refs = view_refs(g)
    log(f"  {name}: {n} rows, {ent} of {e} edges in the view; the view's "
        f"build {build_ms:.4f} device-ms")
    ir, cr, is_, cs = v.indptr_r, v.col_r, v.indptr_s, v.col_s

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def by_pos(t):
        return t if v.eid_r is None else t.index_select(0, v.eid_r.long())

    idx = 4 * (n + 1 + ent)
    for h, d, dt in shapes["gat"]:
        b = 2 if dt == torch.bfloat16 else 4
        pi, pj, vals, dy = rn(n, h, dtype=dt), rn(n, h, dtype=dt), \
            rn(n, h, d, dtype=dt), rn(n, h, d, dtype=dt)
        nh, nhd = b * n * h, b * n * h * d
        # with no L2 reuse every edge reads a value row and a scalar of its
        # sender (K3, K4, K12) or its receiver's row and scalars (K5)
        rows_again, scalar_again = b * ent * h * d - nhd, b * ent * h - nh
        sfx = "" if dt == torch.float32 else " bf16"
        hd = f"{name} H={h} D={d}{sfx}"
        key = "k3" + sfx.replace(" ", "_")
        num, m, s = view_case(
            res, card, key, hd, lambda: ES.gat_softmax(ir, cr, pi, pj, vals,
                                                       0.2),
            lambda: refs["k3"](pi, pj, vals, 0.2),
            idx + 2 * nh + 2 * nhd + 8 * n * h, ent * h * (2 * d + 6),
            [("num", {"rtol": 1e-2 if sfx else RTOL}), ("m", {}),
             ("s", {})], again=rows_again + scalar_again)
        if sfx:
            continue
        out, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, d))
        bwd = (pi, pj, vals, mx, den, (out * dy).sum(-1), dy, 0.2)
        view_case(res, card, "k4", hd, lambda: ES.gat_bwd_dpi(ir, cr, *bwd),
                  lambda: refs["k4"](*bwd), idx + 6 * nh + 2 * nhd,
                  ent * h * (2 * d + 10), again=rows_again + scalar_again)
        view_case(res, card, "k5", hd, lambda: ES.gat_bwd_rev(is_, cs, *bwd),
                  lambda: refs["k5"](*bwd), idx + 6 * nh + 3 * nhd,
                  ent * h * (4 * d + 10),
                  again=rows_again + 4 * scalar_again)
        lg, mask = rn(e, h), (rn(e, h) > 0).float() * 2
        lg_p, mask_p = by_pos(lg), by_pos(mask)
        view_case(res, card, "k12", f"{hd} node values + dropout mask",
                  lambda: ES.edge_softmax(ir, cr, lg_p, mask_p, vals),
                  lambda: refs["k12"](lg, mask, vals),
                  idx + 8 * ent * h + 2 * nhd + 2 * nh,
                  ent * h * (2 * d + 6), again=rows_again)
        del pi, pj, vals, dy, num, out, bwd, lg, mask, lg_p, mask_p
    for h, o in shapes["gatv2"]:
        q, k, dy = rn(n, h, o), rn(n, h, o), rn(n, h, o)
        a = rn(o, h) * (2.0 / (o + h)) ** 0.5
        nh, nhd, ah = 4 * n * h, 4 * n * h * o, 4 * o * h
        rows_again, scalar_again = 4 * ent * h * o - nhd, 4 * ent * h - nh
        hd = f"{name} H={h} O={o}"
        num, m, s = view_case(
            res, card, "k9", hd, lambda: ES.gatv2_softmax(ir, cr, q, k, a,
                                                          0.2),
            lambda: refs["k9"](q, k, a, 0.2), idx + 3 * nhd + ah + 2 * nh,
            ent * h * (6 * o + 6), again=rows_again)
        out, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, o))
        bwd = (q, k, a, mx, den, (out * dy).sum(-1), dy, 0.2)
        # da sums one term per edge: held to the float64 reference, as
        # phase 2c holds it (DA_ATOL_REL)
        da64 = refs["k10"](*[t.double() if torch.is_tensor(t) else t
                             for t in bwd])[1]
        view_case(res, card, "k10", hd, lambda: ES.gatv2_bwd_dq(ir, cr, *bwd),
                  lambda: (refs["k10"](*bwd)[0], da64),
                  idx + 4 * nhd + 3 * nh + 2 * ah, ent * h * (11 * o + 8),
                  [("dq", {}), ("da vs float64", {
                      "atol": DA_ATOL_REL * float(da64.abs().max())})],
                  again=rows_again)
        view_case(res, card, "k11", hd, lambda: ES.gatv2_bwd_rev(is_, cs, *bwd),
                  lambda: refs["k11"](*bwd), idx + 4 * nhd + 3 * nh + ah,
                  ent * h * (11 * o + 8),
                  again=2 * rows_again + 3 * scalar_again)
        del q, k, dy, num, out, bwd
    for h, o, d in shapes["dot"]:
        q, k, vals, dy = rn(n, h, o), rn(n, h, o), rn(n, h, d), rn(n, h, d)
        scale, nh = o ** -0.5, 4 * n * h
        no_, nd, eh = 4 * n * h * o, 4 * n * h * d, 4 * ent * h
        rows_again = 4 * ent * h * (o + d) - no_ - nd
        hd = f"{name} H={h} O={o} D={d}"
        raw = torch.empty(e, h, device=dev)
        num, m, s = view_case(
            res, card, "k6", hd,
            lambda: ES.dot_softmax(ir, cr, q, k, vals, scale, None, raw),
            lambda: refs["k6"](q, k, vals, scale, None),
            idx + 2 * no_ + 2 * nd + 2 * nh + eh,
            ent * h * (2 * o + 2 * d + 8), again=rows_again)
        out, mx, den = ES.finalize_softmax(num, m, s, rn(n, h), rn(n, h, d))
        bwd = (q, k, vals, mx, den, (out * dy).sum(-1), dy, scale, None)
        view_case(res, card, "k7", hd,
                  lambda: ES.dot_bwd_dq(ir, cr, *bwd, raw),
                  lambda: refs["k7"](*bwd),
                  idx + 2 * no_ + 2 * nd + 3 * nh + eh,
                  ent * h * (2 * o + 2 * d + 10), again=rows_again)
        view_case(res, card, "k8", hd, lambda: ES.dot_bwd_rev(is_, cs, *bwd),
                  lambda: refs["k8"](*bwd),
                  idx + 3 * no_ + 3 * nd + 3 * nh,
                  ent * h * (4 * o + 4 * d + 10),
                  again=rows_again + 3 * (eh - nh))
        del q, k, vals, dy, num, out, bwd, raw
    # K13 computes every edge, the invalid ones too (JAX's apply_edges and
    # dot_attention_logits read no mask): the graph's own receiver CSR,
    # the dots written back to edge order through eid_r
    r_all, s_all = g.receivers, g.senders
    for h, d in shapes["k13"]:
        xi, xj = rn(n, h, d), rn(n, h, d)
        ip, col = g.indptr_r, g.col_r
        # the library yardstick, as phase 2e's: the CSR with all-ones
        # values times xi @ xj^T, batched over the heads where there are
        # several (its values in CSR order)
        if h == 1:
            pattern = torch.sparse_csr_tensor(
                ip, col, torch.ones(e, device=dev), (n, n))
            a_, b_ = xi[:, 0], xj[:, 0].t()
        else:
            pattern = torch.sparse_csr_tensor(
                ip.expand(h, -1).contiguous(),
                col.expand(h, -1).contiguous(),
                torch.ones(h, e, device=dev), (h, n, n))
            a_, b_ = xi.transpose(0, 1).contiguous(), xj.permute(1, 2, 0)
        view_case(
            res, card, "k13", f"{name} H={h} D={d} (every edge)",
            lambda: SD.sddmm(g, xi, xj),
            lambda: (xi.index_select(0, r_all)
                     * xj.index_select(0, s_all)).sum(-1),
            4 * (n + 1 + e) + 8 * n * h * d + 4 * e * h, 2 * e * h * d,
            again=4 * e * h * d - 4 * n * h * d, lib=lambda: torch.sparse.sampled_addmm(pattern, a_, b_,
                                                   beta=0.0))
        del xi, xj, pattern, a_, b_
    # K14 and its backward: the entries in CSR order (gathered through
    # eid_r, as the route gathers them), the backward written back to edge
    # order; the reference is the masked scatter max over receiver ids
    ids, r, _ = view_edges(g)
    for f, dt in shapes["k14"]:
        b = 2 if dt == torch.bfloat16 else 4
        sfx = "" if dt == torch.float32 else "_bf16"
        data = (torch.round(rn(e, f) * 4) / 4).to(dt)   # ties
        data_p, dy = by_pos(data), rn(n, f, dtype=dt)
        lbl = f"{name} F={f}" + (" bf16" if sfx else "")
        def want():
            return OS._ScatterExtreme.apply(data.index_select(0, ids), r, n,
                                            False)

        out = view_case(
            res, card, "k14" + sfx, lbl,
            lambda: SG.segment_max_csr(ir, data_p), want,
            4 * (n + 1) + b * ent * f + b * n * f, ent * f, [("out", None)],
            lib=lambda: torch.segment_reduce(data_p[:ent], "max",
                                             offsets=ir))

        def bwd_in_edge_order(dd):
            if v.eid_r is not None:
                dd = torch.empty_like(dd).index_copy_(0, v.eid_r.long(), dd)
            return dd.index_select(0, ids)

        view_case(
            res, card, "k14_bwd" + sfx, lbl,
            lambda: SG.segment_max_bwd_csr(ir, data_p, out, dy),
            lambda: OS.extreme_grad(data.index_select(0, ids), out, r, dy),
            4 * (n + 1) + 2 * b * ent * f + 2 * b * n * f, 2 * ent * f,
            [("ddata", None)], out=bwd_in_edge_order)
        del data, data_p, dy, out
    return build_ms


def view_phase_main(g, card) -> dict:
    """Phase 2l on the main graph's reverse (``g.reverse()``: its receiver
    CSR is ``g``'s sender CSR, read through ``eid_r``) at 3d's (4, 32)
    (K3, also bfloat16, K4, K5, K12 with a dropout mask), 3f's (K9-K11),
    3g's (K6-K8) widths, K13 at 3g's (4, 32) and 3j's F = 128 (K14 and its
    backward, also bfloat16). Returns the cases by kernel."""
    log(f"phase 2l: K3-K14 over the reversed main graph's receiver CSR "
        f"(N={N}, E={E}) vs plain computations over receiver ids")
    t0, res = time.perf_counter(), {}
    f32, bf16 = torch.float32, torch.bfloat16
    hd = D // GAT_HEADS
    view_kernel_cases(res, card, g.reverse(), "reversed", {
        "gat": [(GAT_HEADS, hd, f32), (GAT_HEADS, hd, bf16)],
        "gatv2": [(GAT_HEADS, hd)], "dot": [(GAT_HEADS, hd, hd)],
        "k13": [(GAT_HEADS, hd)], "k14": [(D, f32), (D, bf16)]})
    log_times(res, 44)
    log(f"  2l on the reversed main graph: {time.perf_counter() - t0:.1f} s")
    return res


def view_phase_draw(blocks, card) -> dict:
    """Phase 2l on a 3n draw without replacement: block 0 (the (15, 10)
    slot graph of 1,024 seeds) compacted to its valid edges, at 3w's
    widths: GAT (4, 128) (K3,
    also bfloat16, K4, K5, K12) and (4, 47) (K3-K5, K12), GATv2 (4, 32),
    dot (4, 32, 32), K13 at D = 100 (every edge) and SAGE's F = 100 (K14
    and its backward, also bfloat16). Returns the cases by kernel."""
    log("phase 2l: K3-K14 over a 3n draw's block 0 compacted to its valid "
        "edges vs plain computations over receiver ids")
    t0, res = time.perf_counter(), {}
    f32, bf16 = torch.float32, torch.bfloat16
    res["view_build_device_ms"] = view_kernel_cases(
        res, card, blocks[0], "3n block 0", {
            "gat": [(GAT_OGB_HEADS, GAT_OGB_HIDDEN, f32),
                    (GAT_OGB_HEADS, GAT_OGB_HIDDEN, bf16),
                    (GAT_OGB_HEADS, SAGE_CLASSES, f32)],
            "gatv2": [(GAT_HEADS, D // GAT_HEADS)],
            "dot": [(GAT_HEADS, D // GAT_HEADS, D // GAT_HEADS)],
            "k13": [(1, SAGE_D)], "k14": [(SAGE_D, f32), (SAGE_D, bf16)]})
    build = res.pop("view_build_device_ms")
    log_times(res, 44)
    log(f"  2l on the draw: {time.perf_counter() - t0:.1f} s")
    res["k3"]["variants"][0]["view_build_device_ms"] = build
    return res


def gat_ogb(M, dev):
    """3w's GAT: ``GATConv(100, 128, relu, heads=4)``, ``GATConv(512, 47,
    heads=4, concat=False)`` (PyG's examples/ogbn_products_gat.py widths,
    2 of its 3 hops)."""
    gen = torch.Generator().manual_seed(15)
    h, k = GAT_OGB_HIDDEN, GAT_OGB_HEADS
    return M.GNNChain(
        M.GATConv(SAGE_D, h, torch.relu, heads=k, generator=gen, device=dev),
        M.GATConv(h * k, SAGE_CLASSES, heads=k, concat=False, generator=gen,
                  device=dev))


def sampled_attention_phase(gnn, data, sampler, dev) -> dict:
    """3w: GAT and SAGE with ``aggr="max"`` (GraphSAGE's pooling
    aggregator) over ``DeviceSampler.sample_blocks`` without replacement
    (``sampler``; the slots past a node's degree invalid) on 3n's graph,
    batch 1024, fanouts (15, 10), Adam at 1e-3: 10 timed steps each on one batch
    of seeds (a fresh draw each step), whose loss must fall, with their
    launches (GAT: K3, K4, K5 2 each a step; SAGE: K14 2, its backward 1
    and K1 1, layer 2's, as its input needs a gradient), device ms a step;
    one draw card vs the CPU plain path in float64 at 3c's tolerances."""
    from graphneuralnetworks_tpu_torch import models as M

    t_phase = time.perf_counter()
    X, y = data["X"], data["y"]
    seeds = torch.from_numpy(np.random.default_rng(12).choice(
        data["seeds"], SAGE_BS, replace=False)).to(dev, torch.int32)
    out = {"vs_cpu": {}}
    cells = {"gat": (gat_ogb(M, dev), {"k3": 2, "k4": 2, "k5": 2},
                     GRAD_NORM_RTOL),
             # a max routes a cotangent to one edge: 3c's EdgeConv limit
             "sage_max": (sage_model(M, dev, aggr="max"),
                          {"k14": 2, "k14_bwd": 1, "k1": 1},
                          EDGECONV_GRAD_NORM_RTOL)}
    for name, (model, per_step, grad_rtol) in cells.items():
        log(f"phase 3w: {name} over DeviceSampler.sample_blocks (batch "
            f"{SAGE_BS}, fanouts {SAGE_FANOUTS}), {STEPS} Adam steps on one "
            "batch of seeds")
        layers = list(model.layers)
        convs, head = layers[:2], (layers[2] if len(layers) > 2 else None)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        gen = torch.Generator(device=dev).manual_seed(16)

        def step():
            opt.zero_grad(set_to_none=True)
            blocks, nid = sampler.sample_blocks(gen, seeds)
            h = gnn.apply_blocks(blocks, convs, X.index_select(0, nid))
            loss = sage_loss(h if head is None else head(h[:SAGE_BS]), nid,
                             y)
            loss.backward()
            opt.step()
            return loss.detach()

        step()
        torch.cuda.synchronize()
        reset_counts()
        losses, times = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            losses.append(float(step()))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        log(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f}; ms/step median="
            f"{statistics.median(times):.3f} all={[round(t, 3) for t in times]}"
            f"; launches over {STEPS} steps: {launches}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"3w {name}: the loss did not fall: {losses}")
        expect_counts(f"3w {name}", launches, per_step)
        res = {"losses": losses, "ms_per_step": times,
               "median_ms_per_step": statistics.median(times),
               "launches": launches, "device_ms_per_step": device_ms(step, 3)}
        log(f"  device ms/step {res['device_ms_per_step']:.4f}")
        blocks, nid = sampler.sample_blocks(gen, seeds)
        blocks_cpu = [b.to("cpu") for b in blocks]
        labels = y.index_select(0, nid[:SAGE_BS])

        def forward(m, gg, xx, extra):
            on_card = xx.device.type == "cuda"
            ls = list(m.layers)
            hh = gnn.apply_blocks(blocks if on_card else blocks_cpu, ls[:2],
                                  xx)[:SAGE_BS]
            lg = hh if len(ls) == 2 else ls[2](hh)
            return lg, torch.nn.functional.cross_entropy(
                lg, labels if on_card else labels.cpu())

        log(f"phase 3c (3w): {name} on one draw, card vs the CPU plain path")
        before = read_counts()
        out["vs_cpu"][f"sampled_{name}"] = compare_model(
            f"3w {name}", model, blocks[0], X.index_select(0, nid), None,
            forward=forward, grad_rtol=grad_rtol)
        expect_launched(f"3w {name} (3c)", before, per_step)
        out[name] = res
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  3w: {out['seconds']:.1f} s")
    return out


def reversed_phase(g, x, y, mask, profile: bool):
    """3x: 3d's GAT and 3j's EdgeConv on ``g.reverse()``: 5 Adam steps each
    (the loss falls) with their launches (GAT: K3, K4, K5 2 each a step over
    the reversed CSRs; EdgeConv: K14 and its backward 2 each, K1 2), device
    ms a step, one step card vs the CPU plain path in float64 at 3d's and
    3j's tolerances. Returns its results and None."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import (make_train_step,
                                                        masked_cross_entropy)

    t0, gr = time.perf_counter(), g.reverse()
    res = {"vs_cpu": {}}

    def loss_fn(m, g, x, y, mask):
        return masked_cross_entropy(m(g, x), y, mask)

    for name, model, per_step, grad_rtol in (
            ("gat", gat(M, 2, g.device), {"k3": 2, "k4": 2, "k5": 2},
             GRAD_NORM_RTOL),
            ("edgeconv", edgeconv(M, 11, g.device),
             {"k14": 2, "k14_bwd": 2, "k1": 2}, EDGECONV_GRAD_NORM_RTOL)):
        log(f"phase 3x: {name} on the reversed main graph, 5 Adam steps")
        losses, times, launches, opt = train(model, model.parameters(),
                                             (gr, x, y, mask), loss_fn,
                                             steps=5)
        log(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f}; ms/step median="
            f"{statistics.median(times):.3f}; launches {launches}")
        expect_counts(f"3x {name}", launches, per_step, steps=5)
        step = make_train_step(model, opt, loss_fn)
        dms = device_ms(lambda: step(gr, x, y, mask), 3)
        log(f"  device ms/step {dms:.4f}")
        res[name] = {"losses": losses, "ms_per_step": times,
                     "median_ms_per_step": statistics.median(times),
                     "launches": launches, "device_ms_per_step": dms}
        log(f"phase 3c (3x): {name} on the reversed graph, card vs the CPU "
            "plain path")
        before = read_counts()
        res["vs_cpu"][f"reversed_{name}"] = compare_model(
            f"3x {name}", model, gr, x, lambda extra: {},
            grad_rtol=grad_rtol)
        expect_launched(f"3x {name} (3c)", before, per_step)
        del model, opt, step
    res["seconds"] = time.perf_counter() - t0
    log(f"  3x: {res['seconds']:.1f} s")
    return res, None


# ---- phases 2g, 3m and 3n: neighbor-sampled GraphSAGE at ogbn scale -------

# bench.py's north star (BASELINE.md: epoch time on ogbn-products, GraphSAGE,
# neighbor-sampled): its synthetic ogbn-products analog at full size
# (_sage_graph, bench.py:387-443), GraphSAGE 100 -> 256 -> 256 -> 47, batch
# 1024, fanouts (15, 10) (_run_sage_epoch, _run_sage_device, :467-717)
SAGE_N, SAGE_E, SAGE_TRAIN = 2_449_029, 123_718_280, 196_615
SAGE_D, SAGE_HIDDEN, SAGE_CLASSES = 100, 256, 47
SAGE_BS, SAGE_FANOUTS = 1024, (15, 10)
# 3m: warm-up batches, then the measured window (bench.py measures 30);
# 3n: warm-up, then bench.py's BENCH_SAGE_NB default of 40
SAGE_WARM, SAGE_WINDOW = 10, 30
SAGE_DEV_WARM, SAGE_DEV_BATCHES = 5, 40
# losses averaged at the head and the tail of a run (bench.py:700-702)
SAGE_LOSS_AVG = 5


def sage_data(dev) -> dict:
    """The north-star graph, its train seeds, features and labels.

    bench.py's synthetic recipe draw for draw: ``s`` uniform and ``r = N *
    u**2`` (skewed in-degrees) from ``default_rng(0)``, the seeds
    ``default_rng(1).choice(N, 196_615, replace=False)``. The in-CSR is
    built on the card (``sampling.in_csr``, a stable sort) and copied to
    the host for the C++ sampler. X ``[N, 100]`` and y (47 classes) follow
    bench.py's learnable class-prototype recipe (``_sage_features``), drawn
    by a seeded generator on the card."""
    from graphneuralnetworks_tpu_torch.sampling import in_csr

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    s = rng.integers(0, SAGE_N, SAGE_E, dtype=np.int32)
    r = (SAGE_N * rng.random(SAGE_E) ** 2).astype(np.int32)
    t1 = time.perf_counter()
    csr_send_t, csr_eid_t, ptr_t = in_csr(torch.from_numpy(s).to(dev),
                                          torch.from_numpy(r).to(dev), SAGE_N)
    del s, r
    csr = tuple(t.cpu().numpy() for t in (csr_send_t, csr_eid_t, ptr_t))
    del csr_eid_t
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    seeds = np.random.default_rng(1).choice(SAGE_N, SAGE_TRAIN,
                                            replace=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    y = torch.randint(0, SAGE_CLASSES, (SAGE_N,), generator=gen, device=dev)
    proto = torch.randn(SAGE_CLASSES, SAGE_D, generator=gen, device=dev)
    X = proto[y] + 0.8 * torch.randn(SAGE_N, SAGE_D, generator=gen,
                                     device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    deg = np.diff(csr[2])
    setup = {"draw_s": t1 - t0, "csr_on_card_and_to_host_s": t2 - t1,
             "features_s": t3 - t2,
             "in_degree": {"min": int(deg.min()),
                           "median": float(np.median(deg)),
                           "max": int(deg.max()),
                           "zero": int((deg == 0).sum())}}
    log(f"  sage graph: N={SAGE_N} E={SAGE_E}: numpy draws {t1 - t0:.2f} "
        f"s, CSR on the card and to the host {t2 - t1:.2f} s, features "
        f"{t3 - t2:.2f} s; in-degree {setup['in_degree']}")
    return {"csr": csr, "csr_send_t": csr_send_t, "ptr_t": ptr_t,
            "seeds": seeds, "X": X, "y": y, "setup": setup}


def sage_model(M, dev, aggr="mean"):
    gen = torch.Generator().manual_seed(14)
    torch.manual_seed(14)
    return M.GNNChain(
        M.SAGEConv(SAGE_D, SAGE_HIDDEN, torch.relu, aggr=aggr, generator=gen,
                   device=dev),
        M.SAGEConv(SAGE_HIDDEN, SAGE_HIDDEN, torch.relu, aggr=aggr,
                   generator=gen, device=dev),
        torch.nn.Linear(SAGE_HIDDEN, SAGE_CLASSES, device=dev))


def sage_loss(logits, nid, y):
    """Softmax cross-entropy over the batch's first ``SAGE_BS`` rows, the
    seeds (bench.py:672-673)."""
    return torch.nn.functional.cross_entropy(
        logits[:SAGE_BS], y.index_select(0, nid[:SAGE_BS]))


def k1_csr_case(res, card, label, paths, indptr, col, eid, w, vals, d,
                gen) -> tuple:
    """K1 over a square CSR (weights ``w`` or None) on a random ``[rows,
    d]`` source table, held and timed by :func:`k1_timed_case` with
    ``torch.sparse.mm`` over the same CSR (values ``vals``) as the library
    yardstick; returns K1's arguments."""
    n_rows = indptr.numel() - 1
    x = torch.randn(n_rows, d, generator=gen, device=indptr.device)
    a = torch.sparse_csr_tensor(indptr, col, vals, (n_rows, n_rows))
    args = (indptr, col, eid, w, x)
    k1_timed_case(res, card, label, paths, args,
                  lambda: torch.sparse.mm(a, x))
    return args


def sage_kernel_cases(res, card, gm, blocks) -> list:
    """Phase 2g: K1 at the shapes 3m and 3n give it, held to the plain
    version and ``torch.sparse.mm`` and timed (:func:`k1_timed_case`). 3n's
    blocks carry ``edge_valid``, which K1 takes as 0/1 weights: block 0's
    receiver CSR at D = 100 (16,384 rows of 10 or 15 edges among 169,984),
    block 1's at D = 256 and its sender CSR at D = 256 (layer 2's
    backward). 3m's batch graph (unweighted) at D = 100 and 256 forward
    and 256 backward. Returns ``(label, args)`` per case for the sweep."""
    dev = (gm or blocks[0]).device
    gen = torch.Generator(device=dev).manual_seed(21)
    cases = []

    def case(label, *args):
        cases.append((label, k1_csr_case(res, card, label, *args, gen)))

    if blocks is not None:
        b0, b1 = blocks
        w0, w1 = (b.edge_valid.float() for b in blocks)
        # a block's sender grouping positions are its edge ids (eid_s None)
        case("3n block 0 fwd receiver-CSR valid-weighted D=100",
             "3n SAGE layer 1 fwd (1/step)", b0.indptr_r, b0.col_r, None,
             w0, w0, SAGE_D)
        case("3n block 1 fwd receiver-CSR valid-weighted D=256",
             "3n SAGE layer 2 fwd (1/step)", b1.indptr_r, b1.col_r, None,
             w1, w1, SAGE_HIDDEN)
        case("3n block 1 bwd sender-CSR valid-weighted D=256",
             "3n SAGE layer 2 bwd (1/step)", b1.indptr_s, b1.col_s,
             b1.eid_s, w1, w1, SAGE_HIDDEN)
    if gm is not None:
        ones = torch.ones(gm.num_edges, device=dev)
        case("3m batch fwd receiver-CSR D=100", "3m SAGE layer 1 fwd "
             "(1/step)", gm.indptr_r, gm.col_r, None, None, ones, SAGE_D)
        case("3m batch fwd receiver-CSR D=256", "3m SAGE layer 2 fwd "
             "(1/step)", gm.indptr_r, gm.col_r, None, None, ones,
             SAGE_HIDDEN)
        case("3m batch bwd sender-CSR D=256", "3m SAGE layer 2 bwd "
             "(1/step)", gm.indptr_s, gm.col_s, gm.eid_s, None, ones,
             SAGE_HIDDEN)
    return cases


def sage_losses(name, losses) -> tuple[float, float]:
    """The mean loss of the first and of the last ``SAGE_LOSS_AVG`` steps;
    raises unless every loss is finite and the tail's is below the
    head's (the learnable target must train: bench.py:589-590, 715-716)."""
    lv = [float(v) for v in losses]
    if not all(np.isfinite(lv)):
        raise AssertionError(f"{name}: non-finite loss: {lv}")
    head = sum(lv[:SAGE_LOSS_AVG]) / SAGE_LOSS_AVG
    tail = sum(lv[-SAGE_LOSS_AVG:]) / SAGE_LOSS_AVG
    log(f"  loss: head {head:.6f} -> tail {tail:.6f} ({len(lv)} steps: "
        f"{[round(v, 4) for v in lv]})")
    if not tail < head:
        raise AssertionError(f"{name}: loss did not fall: {head} -> {tail}")
    return head, tail


def sage_host_phase(data, loader, dev, profile) -> dict:
    """3m: ``NeighborLoader`` over the C++ sampler through
    ``Prefetcher(size=4, workers=1)``, Adam at 1e-3: ``SAGE_WARM`` batches,
    then a window of ``SAGE_WINDOW`` with the launch counts of exactly its
    steps (K1 three a step: each conv's forward, layer 2's x-backward;
    ``X[nid]`` needs no gradient). Losses are read after the window."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.sampling import Prefetcher
    from graphneuralnetworks_tpu_torch.training import make_train_step

    log(f"phase 3m: GraphSAGE over NeighborLoader + Prefetcher(size=4, "
        f"workers=1), batch {SAGE_BS}, fanouts {SAGE_FANOUTS}, "
        f"{SAGE_WARM} warm-up batches and {SAGE_WINDOW} measured")
    X, y = data["X"], data["y"]
    model = sage_model(M, dev)

    def loss_fn(m, gb):
        nid = gb.nodes["NID"]
        return sage_loss(m(gb, X.index_select(0, nid)), nid, y)

    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3), loss_fn)
    pf = Prefetcher(loader, size=4, workers=1)
    batches = iter(pf)
    losses = [step(next(batches)) for _ in range(SAGE_WARM)]
    torch.cuda.synchronize()
    reset_counts()
    busy0, edges = pf.host_busy_s, 0
    t0 = time.perf_counter()
    for _ in range(SAGE_WINDOW):
        gb = next(batches)
        edges += gb.num_edges
        losses.append(step(gb))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = pf.host_busy_s - busy0
    launches = read_counts()
    head, tail = sage_losses("3m", losses)
    expect_counts("3m", launches, {"k1": 3}, steps=SAGE_WINDOW)
    out = {"ms_per_batch": wall / SAGE_WINDOW * 1e3,
           "sampled_edges_per_s": edges / wall,
           "sampler_host_ms_per_batch": busy / SAGE_WINDOW * 1e3,
           "sampler_util": busy / wall, "window_batches": SAGE_WINDOW,
           "edges_per_batch": edges / SAGE_WINDOW, "loss_head": head,
           "loss_tail": tail, "losses": [float(v) for v in losses],
           "launches": launches,
           "epoch_s": wall / SAGE_WINDOW * len(loader)}
    log(f"  3m: {out['ms_per_batch']:.3f} ms/batch (host clock over "
        f"{SAGE_WINDOW}), {out['sampled_edges_per_s']:.4g} sampled edges/s "
        f"({out['edges_per_batch']:.0f} a batch), sampler "
        f"{out['sampler_host_ms_per_batch']:.3f} host-ms/batch, "
        f"utilisation {out['sampler_util']:.3f}; launches {launches}")
    if profile:
        out["profile"] = profile_calls(lambda: step(next(batches)), None)
    log("phase 3c (3m): one forward+backward of the SAGE model on a 3m "
        "batch, card vs the CPU plain path")
    gb = next(batches)
    nid = gb.nodes["NID"]

    def forward(m, gg, xx, extra):
        logits = m(gg, xx)[:SAGE_BS]
        return logits, torch.nn.functional.cross_entropy(
            logits, gg.nodes["y"][:SAGE_BS])

    # 3c's tolerances hold at these shapes: a weight gradient sums at most
    # 169,984 per-node terms, so its float32 error by norm is about
    # eps * log2(N) * sqrt(N) = 6e-8 * 17.4 * 412 ~ 4.3e-4 < 1e-3
    out["vs_cpu"] = compare_model(
        "SAGE on a 3m batch", model, gb.with_nodes(y=y.index_select(0, nid)),
        X.index_select(0, nid), None, forward=forward)
    return out


def sage_device_phase(gnn, data, sampler, dev, profile) -> dict:
    """3n: ``DeviceSampler.sample_blocks`` and ``apply_blocks`` with a CUDA
    ``torch.Generator``, Adam at 1e-3: ``SAGE_DEV_WARM`` batches, then
    ``SAGE_DEV_BATCHES`` measured with their launch counts (K1 three a
    step, as 3m). Seeds are drawn from the train seeds with replacement
    (bench.py:565). Then ``sample`` against ``sample_blocks`` on one draw,
    and the blocks card vs CPU."""
    from graphneuralnetworks_tpu_torch import models as M

    log(f"phase 3n: GraphSAGE over DeviceSampler.sample_blocks, batch "
        f"{SAGE_BS}, fanouts {SAGE_FANOUTS}, {SAGE_DEV_WARM} warm-up "
        f"batches and {SAGE_DEV_BATCHES} measured")
    X, y = data["X"], data["y"]
    model = sage_model(M, dev)
    convs, head = list(model.layers[:2]), model.layers[2]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(3)
    picks = torch.from_numpy(np.random.default_rng(4).choice(
        data["seeds"], (SAGE_DEV_WARM + SAGE_DEV_BATCHES + 8, SAGE_BS))
    ).to(dev, torch.int32)
    picked = iter(picks)

    def step():
        opt.zero_grad(set_to_none=True)
        blocks, nid = sampler.sample_blocks(gen, next(picked))
        h = gnn.apply_blocks(blocks, convs, X.index_select(0, nid))
        loss = sage_loss(head(h[:SAGE_BS]), nid, y)
        loss.backward()
        opt.step()
        return loss.detach(), blocks[0].edge_valid.sum()

    losses = [step()[0] for _ in range(SAGE_DEV_WARM)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    counted = [step() for _ in range(SAGE_DEV_BATCHES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses += [c[0] for c in counted]
    edges = sum(int(c[1]) for c in counted)
    head_loss, tail_loss = sage_losses("3n", losses)
    expect_counts("3n", launches, {"k1": 3}, steps=SAGE_DEV_BATCHES)
    out = {"ms_per_batch": wall / SAGE_DEV_BATCHES * 1e3,
           "sampled_edges_per_s": edges / wall,
           "valid_edges_per_batch": edges / SAGE_DEV_BATCHES,
           "batches": SAGE_DEV_BATCHES, "loss_head": head_loss,
           "loss_tail": tail_loss, "losses": [float(v) for v in losses],
           "launches": launches}
    log(f"  3n: {out['ms_per_batch']:.3f} ms/batch (host clock over "
        f"{SAGE_DEV_BATCHES}), {out['sampled_edges_per_s']:.4g} sampled "
        f"(valid) edges/s ({out['valid_edges_per_batch']:.0f} of "
        f"{sampler.e_total} a batch); launches {launches}")
    if profile:
        out["profile"] = profile_calls(step, None)

    log("phase 3c (3n): sample against sample_blocks on one draw (seed "
        "rows), then the blocks card vs the CPU plain path")
    seeds = next(picked)
    state = gen.get_state()
    full = sampler.sample(gen, seeds)
    gen.set_state(state)
    blocks, nid = sampler.sample_blocks(gen, seeds)
    e1 = blocks[1].num_edges
    if not (torch.equal(nid, full.nodes["NID"]) and torch.equal(
            blocks[1].edge_valid, full.edge_valid[:e1])):
        raise AssertionError("3n: sample and sample_blocks drew apart")
    with torch.no_grad():
        h = X.index_select(0, nid)
        for c in convs:
            h = c(full, h)
        # both float32 on the card: the same sums over other layouts
        # (rows per warp, GEMM shapes), so rounding only (RTOL / ATOL)
        out["sample_vs_blocks_err"] = compare(
            "3n sample vs sample_blocks logits", head(h[:SAGE_BS]),
            head(gnn.apply_blocks(blocks, convs, X.index_select(0, nid))
                 [:SAGE_BS]))
    blocks_cpu = [b.to("cpu") for b in blocks]
    labels = y.index_select(0, nid[:SAGE_BS])

    def forward(m, gg, xx, extra):
        on_card = xx.device.type == "cuda"
        hh = gnn.apply_blocks(blocks if on_card else blocks_cpu,
                              list(m.layers[:2]), xx)
        logits = m.layers[2](hh[:SAGE_BS])
        return logits, torch.nn.functional.cross_entropy(
            logits, labels if on_card else labels.cpu())

    out["vs_cpu"] = compare_model("SAGE on a 3n block set", model,
                                  blocks[0], X.index_select(0, nid), None,
                                  forward=forward)
    return out


def sage_phases(gnn, dev, card, which, profile, sweep) -> tuple:
    """Phases 2g, 3m and 3n (``which`` of "3m", "3n", "2l", "3w") on one
    north-star graph: its set-up, the loader's and the sampler's, then 2g's
    K1 cases on a 3m batch and a 3n draw (and, with ``sweep``, K1 at every
    layout there), then 3m and 3n; 2l's cases on a 3n draw and 3w. Returns
    ``(results, {kernel: 2g's and 2l's cases})``."""
    from graphneuralnetworks_tpu_torch.device_sampler import DeviceSampler
    from graphneuralnetworks_tpu_torch.sampling import NeighborLoader

    log(f"phases 2g, {', '.join(which)}: neighbor-sampled GraphSAGE at "
        "ogbn-products scale")
    data = sage_data(dev)
    res = {"setup": data["setup"]}
    loader = sampler = gm = blocks = None
    if "3m" in which:
        t0 = time.perf_counter()
        loader = NeighborLoader.from_csr(
            *data["csr"], num_nodes=SAGE_N,
            num_neighbors=list(SAGE_FANOUTS), batch_size=SAGE_BS,
            input_nodes=data["seeds"], minimal_batch=True, seed=2,
            device=dev)
        gm = loader.sample_batch(data["seeds"][:SAGE_BS],
                                 np.random.default_rng(5))
        torch.cuda.synchronize()
        res["setup"]["loader_and_first_batch_s"] = time.perf_counter() - t0
    if {"3n", "2l", "3w"} & set(which):
        t0 = time.perf_counter()
        sampler = DeviceSampler.build(data["csr_send_t"], data["ptr_t"],
                                      fanouts=SAGE_FANOUTS,
                                      batch_size=SAGE_BS, device=dev)
        torch.cuda.synchronize()
        res["setup"]["device_sampler_build_s"] = time.perf_counter() - t0
        blocks, _ = sampler.sample_blocks(
            torch.Generator(device=dev).manual_seed(6),
            torch.from_numpy(data["seeds"][:SAGE_BS]).to(dev))
    log("  set-up seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["setup"].items()
        if isinstance(v, float)))
    kern = {"k1": {"err": 0.0, "variants": []}}
    if {"3m", "3n"} & set(which):
        log("phase 2g: K1 at the shapes of 3m and 3n vs the plain version")
        cases = sage_kernel_cases(kern, card, gm,
                                  blocks if "3n" in which else None)
        log_times(kern, 50)
        if sweep:
            res["k1_sweep"] = k1_layout_sweep(cases)
        del cases
    if {"2l", "3w"} & set(which):
        # 3n's draws (with replacement) have no invalid edge on this graph,
        # whose every node has in-edges: 2l and 3w draw without
        # replacement, which leaves the slots past a node's degree invalid
        sampler_nr = DeviceSampler.build(
            data["csr_send_t"], data["ptr_t"], fanouts=SAGE_FANOUTS,
            batch_size=SAGE_BS, replace=False, device=dev)
    if "2l" in which:
        blocks_nr, _ = sampler_nr.sample_blocks(
            torch.Generator(device=dev).manual_seed(7),
            torch.from_numpy(data["seeds"][:SAGE_BS]).to(dev))
        kern.update(view_phase_draw(blocks_nr, card))
        del blocks_nr
    if loader is not None:
        res["sage_host"] = sage_host_phase(data, loader, dev, profile)
    if "3n" in which:
        res["sage_device"] = sage_device_phase(gnn, data, sampler, dev,
                                               profile)
    if "3w" in which:
        res["sampled_attention"] = sampled_attention_phase(gnn, data,
                                                           sampler_nr, dev)
    if profile:
        k1_in_step(res, kern)
    return res, kern


def k1_in_step(res, kern) -> None:
    """K1's device time per launch inside a 3m and a 3n step (their
    profiles: layer 1's forward, layer 2's forward, layer 2's backward)
    beside 2g's case of the same shape, its bound and its L2-flushed
    time: the kernel as the step runs it, its inputs evicted or not by the
    work around it."""
    for key, tag in (("sage_host", "3m"), ("sage_device", "3n")):
        prof = res.get(key, {}).get("profile")
        if not prof:
            continue
        cases = [v for v in kern["k1"]["variants"]
                 if v["case"].startswith(tag)]
        per_launch = prof["kernel_ms_per_launch"].get("k1", [])
        if len(per_launch) != len(cases):
            log(f"  K1 in the {tag} step: not measured (the profiler kept "
                f"{len(per_launch)} positions of {len(cases)})")
            continue
        rows = [{"case": v["case"], "in_step_ms": ms,
                 "cold_device_ms": v["cold_device_ms"],
                 "device_ms": v["device_ms"], "bound_ms": v["bound_ms"]}
                for v, ms in zip(cases, per_launch)]
        res[key]["k1_in_step"] = rows
        for r in rows:
            log(f"  K1 in the {tag} step: {r['case']}: {r['in_step_ms']:.4f}"
                f" ms (2g: L2-flushed {r['cold_device_ms']:.4f} ms, "
                f"back-to-back {r['device_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms)")


# ---- phases 2i, 3p and 3q: heterogeneous and temporal graphs --------------

# benchmarks/hetero_temporal_bench_r5.py: 3p (:57-111) two node types of
# 65,536 nodes and three relations of 350,000 uniform edges each, drawn by
# numpy.random.default_rng(0) in its order, d = 128; 3q (:115-137) T = 8
# steps on rand_graph(65,536, 1,000,000, seed=2), d = 128
HT_USERS = HT_ITEMS = 65_536
HT_REL_EDGES = 350_000
HT_RELATIONS = (("user", "rates", "item"), ("item", "rated_by", "user"),
                ("user", "follows", "user"))
HT_T, HT_N, HT_E = 8, 65_536, 1_000_000
# 3q's card-vs-CPU checks: the first HT_CHECK_T steps of the sequence at
# d = 128 (a step of the recurrence already carries its state into the
# next); the other cells run the whole sequence at HT_SMALL_D
HT_CHECK_T, HT_SMALL_D = 2, 16
# K1 launches of one cheb_lambda_max call: 50 power iterations and the
# closing Rayleigh quotient, one SpMM at D = 1 each
CHEB_LAMBDA_K1 = 50 + 1
# 3q's TGCN and A3TGCN card vs CPU: the first GCNConv of each gate ends in
# relu, whose kink passes a pre-activation's cotangent or not by its sign.
# A float32 pre-activation (a 128-wide product of O(1) terms and a ~15-term
# sum: rounding ~1e-6 at a spread ~1) falls on the other side of 0 than in
# float64 with probability ~2 * 1e-6 * 0.4 = 8e-7: ~13 of one gate's
# 16.7M pre-activations over HT_CHECK_T steps at N = 65,536. A flip moves
# one entry of that layer's bias gradient by its cotangent g, against a
# norm of ~|g| sqrt(128 N HT_CHECK_T) (terms of random sign): 2.4e-4 each,
# ~9e-4 for 13 (the weight gradient alike). On the CPU at N = 3,000,
# float32 against float64, one flip read 2.1e-3 and, with gelu in place
# of relu, the same gradient 7e-7. Held to 10x the estimate.
RELU_GRAD_NORM_RTOL = 1e-2


def timed_calls(name: str, fn, per_call: dict, calls: int = 10) -> dict:
    """``fn``'s kernel launches in one call, checked against ``per_call``;
    the host's median over ``calls`` calls, each synchronised; and the
    card's own time per call (:func:`device_ms`)."""
    fn()
    torch.cuda.synchronize()
    reset_counts()
    fn()
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(name, launches, per_call, steps=1)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_ms(fn, calls=5)
    log(f"  {name}: host median {statistics.median(times):.3f} ms/call "
        f"(all {[round(t, 3) for t in times]}), device {dev_ms:.3f} ms/call;"
        f" launches a call {({k: v for k, v in launches.items() if v})}")
    return {"median_ms": statistics.median(times), "ms": times,
            "device_ms": dev_ms, "launches": launches}


def hetero_conv(M, dev):
    """3p's layer: SAGE on the two rating relations, GraphConv on
    ``follows`` (the benchmark's, seeds 0, 1, 2)."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)
    return M.HeteroGraphConv({
        HT_RELATIONS[0]: M.SAGEConv(D, D, generator=gen(0), device=dev),
        HT_RELATIONS[1]: M.SAGEConv(D, D, generator=gen(1), device=dev),
        HT_RELATIONS[2]: M.GraphConv(D, D, generator=gen(2), device=dev)})


def hetero_loss(out):
    """The benchmark's loss: ``(sum out_user^2 + sum out_item^2) * 1e-6``."""
    return (out["user"].square().sum() + out["item"].square().sum()) * 1e-6


def hetero_phase(gnn, dev, card) -> tuple:
    """2i (3p's K1 cases) and 3p: the forward, the forward
    and backward through ``x_user`` (the benchmark's two rows) and 10 Adam
    steps on the layer's parameters and ``x_user``, each with its K1
    launches checked against the count stated from the code, the steps
    profiled; one step card vs CPU in float64 (:func:`compare_model`).
    Returns the results and ``{"k1": 2i's cases}``."""
    from graphneuralnetworks_tpu_torch import models as M

    log("phase 3p: HeteroGraphConv(SAGE, SAGE, GraphConv) over two types of "
        f"{HT_USERS} nodes and three relations of {HT_REL_EDGES} edges, "
        f"d = {D} (benchmarks/hetero_temporal_bench_r5.py:57-111)")
    rng = np.random.default_rng(0)
    sizes = {"user": HT_USERS, "item": HT_ITEMS}
    rels = {et: (rng.integers(0, sizes[et[0]], HT_REL_EDGES, dtype=np.int64),
                 rng.integers(0, sizes[et[2]], HT_REL_EDGES, dtype=np.int64))
            for et in HT_RELATIONS}
    t0 = time.perf_counter()
    hg = gnn.heterograph(rels, num_nodes=sizes, device=dev)
    torch.cuda.synchronize()
    res = {"graph_build_s": time.perf_counter() - t0}
    x = {t: torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                            device=dev) for t, n in sizes.items()}
    log(f"  heterograph (three relations grouped on the card): "
        f"{res['graph_build_s']:.2f} s")
    conv = hetero_conv(M, dev)
    # K1 a step: one forward per relation (SAGE mean and GraphConv sum: one
    # SpMM each), and one sender-CSR backward per relation whose source
    # type needs a gradient: x_user's, in "rates" and "follows"
    fwd_k1 = len(conv.etypes)
    step_k1 = fwd_k1 + sum(et[0] == "user" for et in conv.etypes)

    log("phase 2i: K1 at 3p's shapes vs the plain version")
    kern = {"k1": {"err": 0.0, "variants": []}}
    gen = torch.Generator(device=dev).manual_seed(31)
    rg = hg.relation_graph(HT_RELATIONS[0])
    ones = torch.ones(HT_REL_EDGES, device=dev)
    k1_csr_case(kern, card, "3p relation fwd receiver-CSR D=128",
                f"3p HeteroGraphConv fwd, one a relation ({fwd_k1}/step)",
                rg.indptr_r, rg.col_r, None, None, ones, D, gen)
    # the sender CSR cut to the source type's rows (both types have
    # HT_USERS nodes here, so the cut CSR stays square)
    k1_csr_case(kern, card, "3p relation bwd sender-CSR D=128",
                f"3p bwd of the relations from user ({step_k1 - fwd_k1}"
                "/step)", rg.indptr_s[: HT_USERS + 1], rg.col_s, rg.eid_s,
                None, ones, D, gen)
    log_times(kern, 40)

    def fwd():
        with torch.no_grad():
            return conv(hg, x)

    xu = x["user"].clone().requires_grad_()

    def fwd_bwd():
        loss = hetero_loss(conv(hg, {"user": xu, "item": x["item"]}))
        return torch.autograd.grad(loss, [xu])[0]

    res["fwd"] = timed_calls("3p fwd", fwd, {"k1": fwd_k1})
    res["fwd_bwd_x_user"] = timed_calls("3p fwd+bwd(x_user)", fwd_bwd,
                                        {"k1": step_k1})
    log(f"phase 3p: {STEPS} Adam steps (lr=1e-3) on the layer's parameters "
        "and x_user, the benchmark's loss")
    xu_p = torch.nn.Parameter(x["user"].clone())

    def loss_fn(m, g, xu, xi):
        return hetero_loss(m(g, {"user": xu, "item": xi}))

    res["train"] = train_phase("HeteroGraphConv", conv, (hg, xu_p, x["item"]),
                               loss_fn, {"k1": step_k1}, True,
                               params=[*conv.parameters(), xu_p])
    log("phase 3p (3c): one step of the layer on the card vs the CPU plain "
        "path in float64, the gradient of x_user too (extra0)")

    def step(m, g, xi, extra):
        out = m(g, {"user": extra[0], "item": xi})
        return torch.cat([out["user"], out["item"]]), hetero_loss(out)

    res["vs_cpu"] = compare_model(
        "HeteroGraphConv", conv, hg, x["item"], None,
        [x["user"].clone().requires_grad_()], forward=step)
    return res, kern


def temporal_models(M, dev, d):
    """3q's recurrences at width ``d`` (generators seeded 3 to 8)."""
    def gen(seed):
        return dict(generator=torch.Generator().manual_seed(seed),
                    device=dev)
    return {"TGCN": M.TGCN(d, d, **gen(3)),
            "GConvGRU": M.GConvGRU(d, d, 2, **gen(4)),
            "GConvLSTM": M.GConvLSTM(d, d, 2, **gen(5)),
            "DCGRU": M.DCGRU(d, d, 2, **gen(6)),
            "EvolveGCNO": M.EvolveGCNO(d, d, **gen(7)),
            "A3TGCN": M.A3TGCN(d, d, **gen(8))}


def temporal_k1(name: str, t: int, backward: bool) -> int:
    """K1 launches of one call of 3q's model ``name`` over ``t`` steps
    (inputs that need no gradient; with ``backward``, its parameters'
    backward too), counted from the code:
    - TGCN (A3TGCN's recurrence): three gates of two GCNConvs, one SpMM
      each (W after the propagation at in = out); backward, layer 2's of
      each gate (layer 1 propagates the input);
    - GConvGRU: six ChebConvs k=2, one hop each; backward, the three on
      the state, but at step 0 only conv_h_h's (r * h needs a gradient, the
      zero h does not);
    - GConvLSTM: eight ChebConvs k=2; backward, the four on the state from
      step 1 on;
    - DCGRU: three DConvs k=2, one hop over g and one over its reverse;
      backward, the three from step 1 on, and dconv_c's at step 0 (its h *
      r needs a gradient);
    - EvolveGCNO: one GCNConv on the input; no backward SpMM (the weight
      comes after the propagation).
    The default ChebConv cells add one cheb_lambda_max (CHEB_LAMBDA_K1) a
    call; these counts take lambda_max as given."""
    fwd, bwd = {"TGCN": (6, 3 * t), "A3TGCN": (6, 3 * t),
                "GConvGRU": (6, 1 + 3 * (t - 1)),
                "GConvLSTM": (8, 4 * (t - 1)),
                "DCGRU": (6, 2 + 6 * (t - 1)), "EvolveGCNO": (1, 0)}[name]
    return fwd * t + (bwd if backward else 0)


def temporal_phase(gnn, dev, card) -> tuple:
    """2i (3q's K1 cases) and 3q: TGCN's and GConvGRU's
    forward over T = 8 steps (GConvGRU with the default λ_max, once a call,
    and with lambda_max= computed once), cheb_lambda_max alone, 10 Adam
    steps of TGCN on a regression loss, each with its K1 launches checked
    (D = 128 and D = 1 apart: the power iteration is the only D = 1 work),
    profiled; card vs CPU in float64 over the first HT_CHECK_T steps, and
    GConvLSTM, DCGRU, EvolveGCNO and A3TGCN at d = HT_SMALL_D over all T,
    forward and backward, not timed. Returns the results and ``{"k1":
    2i's cases}``."""
    from graphneuralnetworks_tpu_torch import models as M

    log(f"phase 3q: GNNRecurrence(TGCNCell({D}, {D})) and "
        f"GNNRecurrence(GConvGRUCell({D}, {D}, 2)) over T = {HT_T} steps on "
        f"rand_graph({HT_N}, {HT_E}, seed=2) "
        "(benchmarks/hetero_temporal_bench_r5.py:115-137)")
    t0 = time.perf_counter()
    g = gnn.rand_graph(HT_N, HT_E, seed=2, device=dev)
    torch.cuda.synchronize()
    res = {"graph_build_s": time.perf_counter() - t0, "vs_cpu": {}}
    gen = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(HT_T, HT_N, D, generator=gen, device=dev)
    target = torch.randn(HT_T, HT_N, D, generator=gen, device=dev)

    log("phase 2i: K1 at 3q's shapes vs the plain version")
    kern = {"k1": {"err": 0.0, "variants": []}}
    ones = torch.ones(HT_E, device=dev)
    for label, paths, csr, d in (
            ("3q fwd receiver-CSR D=128",
             f"3q TGCN and GConvGRU fwd (6/step, {6 * HT_T}/call)",
             (g.indptr_r, g.col_r, None), D),
            ("3q bwd sender-CSR D=128", f"3q TGCN bwd (3/step, "
             f"{3 * HT_T}/call)", (g.indptr_s, g.col_s, g.eid_s), D),
            ("3q fwd receiver-CSR D=1",
             f"3q cheb_lambda_max ({CHEB_LAMBDA_K1}/call)",
             (g.indptr_r, g.col_r, None), 1)):
        k1_csr_case(kern, card, label, paths, *csr, None, ones, d, gen)
    log_times(kern, 40)

    models = temporal_models(M, dev, D)
    tgcn, gru = models["TGCN"], models["GConvGRU"]

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    res["cheb_lambda_max"] = timed_calls(
        "3q cheb_lambda_max (D = 1)", lambda: M.cheb_lambda_max(g),
        {"k1": CHEB_LAMBDA_K1})
    lam = M.cheb_lambda_max(g)
    log(f"  lambda_max = {float(lam[0]):.6f}")
    res["tgcn_fwd"] = timed_calls(
        "3q TGCN fwd (D = 128)", no_grad(lambda: tgcn(g, x)),
        {"k1": temporal_k1("TGCN", HT_T, False)})
    res["gconvgru_fwd"] = timed_calls(
        "3q GConvGRU fwd, default lambda_max (D = 128 and D = 1)",
        no_grad(lambda: gru(g, x)),
        {"k1": temporal_k1("GConvGRU", HT_T, False) + CHEB_LAMBDA_K1})
    res["gconvgru_fwd_lambda"] = timed_calls(
        "3q GConvGRU fwd, lambda_max given (D = 128)",
        no_grad(lambda: gru(g, x, lambda_max=lam)),
        {"k1": temporal_k1("GConvGRU", HT_T, False)})
    for key, fn in (("gconvgru_fwd", lambda: gru(g, x)),
                    ("gconvgru_fwd_lambda",
                     lambda: gru(g, x, lambda_max=lam))):
        log(f"  profile of {key}:")
        res[key]["profile"] = profile_calls(no_grad(fn), None)

    log(f"phase 3q: TGCN, {STEPS} Adam steps (lr=1e-3), mean squared error "
        "against a target drawn from the seed")

    def loss_fn(m, g, x, target):
        return (m(g, x) - target).square().mean()

    res["tgcn_train"] = train_phase(
        "TGCN", tgcn, (g, x, target), loss_fn,
        {"k1": temporal_k1("TGCN", HT_T, True)}, True)

    log(f"phase 3q (3c): TGCN and GConvGRU (lambda_max given) over the first "
        f"{HT_CHECK_T} steps, the card vs the CPU plain path in float64")

    def seq_step(target, **call):
        """A recurrence's output and its squared error against
        ``target`` (its CPU float64 copy on the CPU side)."""
        on_cpu = target.cpu().double()

        def run(m, g, x, extra):
            y = m(g, x, **{k: v.to(x.device, x.dtype)
                           for k, v in call.items()})
            return y, (y - (target if x.is_cuda else on_cpu)).square().mean()
        return run

    xc, tc = x[:HT_CHECK_T].contiguous(), target[:HT_CHECK_T]
    res["vs_cpu"]["tgcn"] = compare_model(
        "TGCN", tgcn, g, xc, None, forward=seq_step(tc),
        grad_rtol=RELU_GRAD_NORM_RTOL)
    res["vs_cpu"]["gconvgru"] = compare_model(
        "GConvGRU", gru, g, xc, None, forward=seq_step(tc, lambda_max=lam))
    del models, tgcn, gru, x, target

    log(f"phase 3q (3c): GConvLSTM (lambda_max given), DCGRU, EvolveGCNO and "
        f"A3TGCN at d = {HT_SMALL_D} over T = {HT_T}, forward and backward, "
        "the card vs the CPU plain path in float64, with K1's launches")
    small = temporal_models(M, dev, HT_SMALL_D)
    xs = torch.randn(HT_T, HT_N, HT_SMALL_D, generator=gen, device=dev)
    for name in ("GConvLSTM", "DCGRU", "EvolveGCNO", "A3TGCN"):
        out_shape = (HT_N, HT_SMALL_D) if name == "A3TGCN" else xs.shape
        target = torch.randn(out_shape, generator=gen, device=dev)
        call = {"lambda_max": lam} if name == "GConvLSTM" else {}
        before = read_counts()
        # A3TGCN: its scores' biases shift every step's score of a node
        # alike, which the softmax over time does not see (0 gradient)
        res["vs_cpu"][name] = compare_model(
            name, small[name], g, xs, None,
            forward=seq_step(target, **call),
            grad_rtol=(RELU_GRAD_NORM_RTOL if name == "A3TGCN"
                       else GRAD_NORM_RTOL),
            zero_grads=(("dense1.bias", "dense2.bias") if name == "A3TGCN"
                        else ()))
        expect_launched(name, before,
                        {"k1": temporal_k1(name, HT_T, True)})

    log(f"phase 3q (3c): TGCN({D}, {D}) over "
        f"TemporalGraph.from_snapshots(uniform=True) of rand_graph(n, 16 n) "
        f"snapshots of n = {TQ_NODES} nodes (padded to {TQ_NODES[0]} nodes "
        f"and {16 * TQ_NODES[0]} edges, the pad edges invalid), forward and "
        "backward, the card vs the CPU plain path in float64")
    t0 = time.perf_counter()
    tq = gnn.TemporalGraph.from_snapshots(
        [gnn.rand_graph(n, 16 * n, seed=40 + i, device=dev)
         for i, n in enumerate(TQ_NODES)], uniform=True)
    tq_cpu = gnn.TemporalGraph.from_snapshots(
        [s.to("cpu") for s in tq.snapshots])
    res["uniform_build_s"] = time.perf_counter() - t0
    if {(s.num_nodes, s.num_edges) for s in tq.snapshots} != {
            (TQ_NODES[0], 16 * TQ_NODES[0])}:
        raise AssertionError("3q: from_snapshots(uniform=True) left "
                             "snapshots of unequal sizes")
    xq = tuple(torch.randn(TQ_NODES[0], D, generator=gen, device=dev)
               for _ in TQ_NODES)
    tq_target = torch.randn(TQ_NODES[0], D, generator=gen, device=dev)

    def tq_forward(m, gg, xx, extra):
        on_card = xx[0].is_cuda
        ys = m(tq if on_card else tq_cpu, list(xx))
        tgt = tq_target if on_card else tq_target.cpu().double()
        return tuple(ys), sum((y - tgt).square().mean() for y in ys)

    before = read_counts()
    res["vs_cpu"]["tgcn_uniform_snapshots"] = compare_model(
        "TGCN over padded snapshots",
        M.TGCN(D, D, generator=torch.Generator().manual_seed(3), device=dev),
        tq.snapshots[0], xq, None, forward=tq_forward,
        grad_rtol=RELU_GRAD_NORM_RTOL)
    expect_launched("TGCN over padded snapshots", before,
                    {"k1": temporal_k1("TGCN", len(TQ_NODES), True)})
    res["uniform_check_s"] = time.perf_counter() - t0
    log(f"  3q over padded snapshots: {res['uniform_check_s']:.1f} s")
    return res, kern


# ---- phase 4 ---------------------------------------------------------------

# ---- phases 2j, 3r and 3s: the link-prediction and graph-classification
# examples ------------------------------------------------------------------

# 3r: examples/link_prediction.py's split fraction and seed (:33-34), its
# negatives' seed (:67) and its learning rate (:51), on the main graph
LINK_FRAC, LINK_SPLIT_SEED, LINK_NEG_SEED, LINK_LR = 0.9, 0, 7, 1e-2
# 3s: examples/graph_classification.py's data, split, loaders and optimiser
# (:27-45): synthetic_tudataset(188, seed=0), 150 train graphs, batches of
# 32 from 2 size buckets, Adam at 1e-3 for 30 epochs
EX_TUD_GRAPHS, EX_TUD_TRAIN, EX_TUD_BS, EX_TUD_BUCKETS = 188, 150, 32, 2
EX_TUD_LR, EX_TUD_EPOCHS = 1e-3, 30


def link_kernel_cases(res, card, train_g, neg, gen) -> None:
    """Phase 2j: K13 over 3r's negative graph's receiver CSR at D = 128
    (``DotDecoder`` on the negatives) and its backward, K1 over the same
    graph's receiver CSR (dxi) and sender CSR (dxj) weighted by the
    upstream gradient, and K1 over ``train_g``'s receiver and sender CSRs
    (the GCN encoder), each held to its plain version and to its library
    call (``torch.sparse.sampled_addmm``, ``torch.sparse.mm``) and timed,
    also after an L2 flush."""
    from graphneuralnetworks_tpu_torch.ops.cuda import sddmm as SD

    dev = neg.device
    ir, cr, e = neg.indptr_r, neg.col_r, neg.num_edges
    xi = torch.randn(N, 1, D, generator=gen, device=dev)
    xj = torch.randn(N, 1, D, generator=gen, device=dev)
    pattern = torch.sparse_csr_tensor(ir, cr, torch.ones(e, device=dev),
                                      (N, N))

    def lib():
        return torch.sparse.sampled_addmm(pattern, xi[:, 0], xj[:, 0].t(),
                                          beta=0.0)

    label = "3r negatives receiver-CSR D=128"
    compare(f"K13 {label} vs sampled_addmm", SD.sddmm_csr(ir, cr, xi, xj),
            lib().values()[:, None])
    kernel_case(res, card, "k13", label, SD.sddmm_csr, SD.sddmm_plain,
                (ir, cr, xi, xj), 4 * (N + 1 + e) + 2 * 4 * N * D + 4 * e,
                2 * e * D, 4 * e * D - 4 * N * D, lib=lib)
    res["k13"]["variants"][-1].update(
        paths="3r DotDecoder on the negatives (1/step)",
        cold_device_ms=cold_device_ms(lambda: SD.sddmm_csr(ir, cr, xi, xj),
                                      ("sddmm_csr_kernel",)))
    del pattern, xi, xj
    dl = torch.randn(e, generator=gen, device=dev)
    k1_csr_case(res, card, "3r negatives bwd dxi receiver-CSR weighted "
                "D=128", "3r DotDecoder(negatives) bwd (1/step)", ir, cr,
                None, dl, dl, D, gen)
    k1_csr_case(res, card, "3r negatives bwd dxj sender-CSR weighted D=128",
                "3r DotDecoder(negatives) bwd (1/step)", neg.indptr_s,
                neg.col_s, neg.eid_s, dl, dl[neg.eid_s.long()], D, gen)
    ones = torch.ones(train_g.num_edges, device=dev)
    k1_csr_case(res, card, "3r train_g fwd receiver-CSR D=128",
                "3r GCN encoder fwd (2/step)", train_g.indptr_r,
                train_g.col_r, None, None, ones, D, gen)
    k1_csr_case(res, card, "3r train_g bwd sender-CSR D=128",
                "3r GCN encoder bwd (1/step); the positives' DotDecoder "
                "bwd is over train_g too (2/step, weighted)",
                train_g.indptr_s, train_g.col_s, train_g.eid_s, None, ones,
                D, gen)


def host_profile(name: str, fn) -> list:
    """``fn()`` once under ``cProfile``: the host's own time of each
    function it runs, largest first (the top 8 logged and returned)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(((tt * 1e3, nc, f"{func[2]} ({os.path.basename(func[0])}"
                    f":{func[1]})") for func, (_, nc, tt, _, _)
                   in pstats.Stats(prof).stats.items()), reverse=True)[:8]
    log(f"  {name}, host ms by function (cProfile, one call): "
        + "; ".join(f"{where} {ms:.1f} x{n}" for ms, n, where in rows))
    return [{"ms": ms, "calls": n, "function": where}
            for ms, n, where in rows]


def link_eval(gnn, model, g, train_g, test_g, x, rng) -> dict:
    """examples/link_prediction.py's held-out check (:72-90): fresh
    negatives of the whole graph, as many as the held-out edges, from the
    training draws' generator; accuracy at threshold 0 averaged over the
    held-out edges and the negatives. Also each side's mean logit and
    share above 0, and how many standard errors the training edges' mean
    logit lies above the negatives' and above that of the same ends paired
    at random (the training senders permuted: the same degrees, no edge).
    On a uniform random graph a held-out edge's ends are no closer in
    ``train_g`` than a random pair, so the held-out means agree and the
    accuracy says nothing; the training edges, which the encoder aggregates
    over, must lead both by more than 5 standard errors, which a decoder on
    the wrong pairs or real edges drawn as negatives would not."""
    def z(a, b):
        return float((a.mean() - b.mean())
                     / (a.var() / a.numel() + b.var() / b.numel()).sqrt())

    neg_t = gnn.negative_sample(g, num_neg_edges=test_g.num_edges, rng=rng)
    perm = torch.randperm(train_g.num_edges,
                          generator=torch.Generator().manual_seed(5))
    ctl = gnn.graph(train_g.senders.cpu()[perm], train_g.receivers.cpu(),
                    num_nodes=train_g.num_nodes, device=x.device)
    with torch.no_grad():
        pos, neg = model(train_g, test_g, neg_t, x)
        trn, rep = model(train_g, train_g, ctl, x)
    return {"acc": 0.5 * (float((pos > 0).float().mean())
                          + float((neg < 0).float().mean())),
            "heldout_pos_mean": float(pos.mean()),
            "neg_mean": float(neg.mean()),
            "heldout_pos_above_0": float((pos > 0).float().mean()),
            "neg_above_0": float((neg > 0).float().mean()),
            "train_pos_mean": float(trn.mean()),
            "repaired_mean": float(rep.mean()),
            "train_vs_neg_se": z(trn, neg),
            "train_vs_repaired_se": z(trn, rep),
            "heldout_vs_neg_se": z(pos, neg)}


def link_example_phases(gnn, g, card, which, profile=False) -> tuple:
    """2j and 3r (``which`` of "2j", "3r"): examples/link_prediction.py's
    flow on the main graph (N = 131,072, E = 2M, bidirected, x [N, 128]):
    ``rand_edge_split(g, 0.9)``; 3i's ``LinkModel`` (GCN encoder 128 ->
    128 -> 128, ``DotDecoder``) trained for STEPS Adam steps at the
    example's 1e-2, each on a fresh ``negative_sample`` of ``train_g`` (as
    many as its edges, one generator for the run) built on the card, the
    example's binary cross-entropy; its held-out accuracy after steps 1 and
    10, with the training edges held above the negatives (:func:`link_eval`);
    the draws timed on the host apart from the graph builds; K13 2 and
    K1 7 launches a step; the steps profiled; one step card vs CPU in
    float64 on the same negatives. 2j first holds K13 and K1 at these
    shapes. Returns the results and 2j's ``{"k13": ..., "k1": ...}``."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch import transform as T
    from graphneuralnetworks_tpu_torch.training import make_train_step

    dev = g.device
    kern = {"k1": {"err": 0.0, "variants": []},
            "k13": {"err": 0.0, "variants": []}}
    log(f"phase 3r: examples/link_prediction.py on the main graph ({N} "
        f"nodes, {E} edges): rand_edge_split(g, {LINK_FRAC})")
    t0 = time.perf_counter()
    train_g, test_g = gnn.rand_edge_split(
        g, LINK_FRAC, rng=np.random.default_rng(LINK_SPLIT_SEED))
    torch.cuda.synchronize()
    res = {"split_s": time.perf_counter() - t0,
           "train_edges": train_g.num_edges, "test_edges": test_g.num_edges}
    if train_g.num_edges + test_g.num_edges != E or not (
            bool(gnn.is_bidirected(train_g))
            and bool(gnn.is_bidirected(test_g))):
        raise AssertionError("rand_edge_split lost edges or split a pair")
    log(f"  rand_edge_split: {res['split_s']:.3f} s ({train_g.num_edges} "
        f"train, {test_g.num_edges} held-out edges, both bidirected; numpy "
        f"{np.__version__})")
    if profile:
        res["split_profile"] = host_profile("rand_edge_split", lambda: (
            gnn.rand_edge_split(g, LINK_FRAC,
                                rng=np.random.default_rng(LINK_SPLIT_SEED)),
            torch.cuda.synchronize()))
    x = node_inputs(g)[1]
    want = train_g.num_edges

    if "2j" in which:
        log("phase 2j: K13 and K1 at 3r's shapes vs the plain versions")
        neg0 = gnn.negative_sample(train_g, num_neg_edges=want,
                                   rng=np.random.default_rng(LINK_NEG_SEED))
        link_kernel_cases(kern, card, train_g, neg0,
                          torch.Generator(device=dev).manual_seed(33))
        log_times(kern, 48)
        del neg0
    if "3r" not in which:
        return res, kern

    # the draw's host part (negative_sample before its graph build) and the
    # build, apart, on the first draws of the run's seed
    rng = np.random.default_rng(LINK_NEG_SEED)
    host_ms, build_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        s, r = T._negative_edges(train_g, want, None, rng)
        t1 = time.perf_counter()
        gnn.graph(s, r, num_nodes=N, device=dev)
        torch.cuda.synchronize()
        host_ms.append((t1 - t0) * 1e3)
        build_ms.append((time.perf_counter() - t1) * 1e3)
    res["negative_sample_host_ms"] = host_ms
    res["negative_graph_build_ms"] = build_ms
    if profile:
        res["negative_sample_profile"] = host_profile(
            "negative_sample's host draw",
            lambda: T._negative_edges(train_g, want, None, rng))
    log(f"  negative_sample({want}) on the host: median "
        f"{statistics.median(host_ms):.1f} ms/call (all "
        f"{[round(v, 1) for v in host_ms]}); its graph build on the card "
        f"{statistics.median(build_ms):.1f} ms ({s.size} edges)")

    log(f"phase 3r: {STEPS} Adam steps (lr={LINK_LR}), each on a fresh "
        "negative_sample of train_g")
    model = LinkModel(M, 9, dev)

    def loss_fn(m, gm, neg, xx):
        return link_loss(*m(gm, gm, neg, xx))

    step = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LINK_LR), loss_fn)
    rng = np.random.default_rng(LINK_NEG_SEED)
    launches = dict.fromkeys(read_counts(), 0)
    draw_ms, step_ms, losses, evals = [], [], [], []
    torch.cuda.synchronize()
    for epoch in range(1, STEPS + 1):
        t0 = time.perf_counter()
        neg = gnn.negative_sample(train_g, num_neg_edges=want, rng=rng)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = read_counts()
        losses.append(float(step(train_g, neg, x)))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        draw_ms.append((t1 - t0) * 1e3)
        for k, v in launched_since(before).items():
            launches[k] += v
        if epoch % 10 == 0 or epoch == 1:
            ev = link_eval(gnn, model, g, train_g, test_g, x, rng)
            evals.append(ev)
            log(f"  step {epoch:3d}  loss {losses[-1]:.4f}  link acc "
                f"{ev['acc']:.4f} (mean logit: held-out edges "
                f"{ev['heldout_pos_mean']:.4f}, negatives "
                f"{ev['neg_mean']:.4f}, training edges "
                f"{ev['train_pos_mean']:.4f}, their ends re-paired "
                f"{ev['repaired_mean']:.4f}; standard errors: training "
                f"edges over negatives {ev['train_vs_neg_se']:.1f}, over "
                f"re-paired {ev['train_vs_repaired_se']:.1f}, held-out "
                f"over negatives {ev['heldout_vs_neg_se']:.1f}; above 0: "
                f"held-out {ev['heldout_pos_above_0']:.4f}, negatives "
                f"{ev['neg_above_0']:.4f})")
    with_draw = [a + b for a, b in zip(draw_ms, step_ms)]
    log(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f}; ms/step median "
        f"{statistics.median(step_ms):.3f} without the draw, "
        f"{statistics.median(with_draw):.3f} with it (negative_sample and "
        f"its build: {statistics.median(draw_ms):.1f}); all steps "
        f"{[round(v, 3) for v in step_ms]}")
    log(f"  launches over {STEPS} steps: {launches}")
    expect_counts("3r link prediction", launches, {"k13": 2, "k1": 3 + 4})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"3r: the loss did not fall: {losses}")
    if not all(np.isfinite(list(a.values())).all()
               and min(a["train_vs_neg_se"], a["train_vs_repaired_se"]) > 5
               for a in evals):
        raise AssertionError("3r: the training edges do not score above the "
                             f"negatives and their ends re-paired: {evals}")
    res.update(losses=losses, link_eval=evals, launches=launches,
               ms_per_step=step_ms, draw_ms=draw_ms,
               median_ms_per_step=statistics.median(step_ms),
               median_ms_per_step_with_draw=statistics.median(with_draw))
    res["profile"] = profile_steps(model, (train_g, neg, x), loss_fn, None)

    log("phase 3r (3c): one step on the card (K1, K13) vs the CPU plain path "
        "in float64, the same negatives on both sides")
    neg_cpu = neg.to("cpu")

    def link_forward(m, gg, xx, extra):
        pos, ng = m(gg, gg, neg_cpu if xx.device.type == "cpu" else neg, xx)
        return torch.cat([pos, ng]), link_loss(pos, ng)

    before = read_counts()
    res["vs_cpu"] = compare_model("link prediction (3r)", model, train_g, x,
                                  None, forward=link_forward)
    expect_launched("link prediction (3r)", before, {"k13": 2, "k1": 7})
    return res, kern


def graph_example_phase(gnn, dev) -> dict:
    """3s: examples/graph_classification.py's loop as it stands (:27-95):
    ``synthetic_tudataset(188, seed=0)``, ``DataLoader``s of the first 150
    (shuffled, seed 1) and the other 38 graphs, batch 32, 2 buckets, built
    on the card; ``GraphConv(7, 64, relu)``, ``GraphConv(64, 64, relu)``,
    ``GlobalPool("mean")``, ``Linear(64, 2)``, Adam at 1e-3 for 30 epochs;
    the train and test accuracy after epochs 1, 5, ..., 30 (iterating the
    train loader there draws, as in the example). The short batches are
    filled with empty graphs, which count in the loss and the accuracy.
    Per batch: the loader's host ms, the step, K1's 3 launches; the steps
    profiled over one epoch's batches; one short batch card vs CPU in
    float64."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.training import make_train_step

    log(f"phase 3s: examples/graph_classification.py: synthetic_tudataset("
        f"{EX_TUD_GRAPHS}), DataLoader(batch_size={EX_TUD_BS}, "
        f"num_buckets={EX_TUD_BUCKETS}), GraphConv(7,64,relu), "
        f"GraphConv(64,64,relu), GlobalPool(mean), Linear(64,2), Adam "
        f"lr={EX_TUD_LR}, {EX_TUD_EPOCHS} epochs")
    graphs, _ = gnn.data.synthetic_tudataset(EX_TUD_GRAPHS, seed=0,
                                             device="cpu")
    train_loader = gnn.data.DataLoader(
        graphs[:EX_TUD_TRAIN], batch_size=EX_TUD_BS, shuffle=True, seed=1,
        num_buckets=EX_TUD_BUCKETS, device=dev)
    test_loader = gnn.data.DataLoader(
        graphs[EX_TUD_TRAIN:], batch_size=EX_TUD_BS,
        num_buckets=EX_TUD_BUCKETS, device=dev)
    model = graph_classifier(M, 15, dev, "mean")

    def loss_fn(m, gb):
        return graph_loss(m(gb, gb.x), gb)

    step = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=EX_TUD_LR), loss_fn)

    def evaluate(loader):
        hit = total = 0.0
        with torch.no_grad():
            for gb in loader:
                mask = gb.graph_mask
                pred = model(gb, gb.x).argmax(-1)
                hit += float(((pred == gb.globals_["y"]) & mask).sum())
                total += float(mask.sum())
        return hit / max(total, 1)

    launches = dict.fromkeys(read_counts(), 0)
    loader_ms, batch_ms, losses, history = [], [], [], []
    n_batches = 0
    torch.cuda.synchronize()
    for epoch in range(1, EX_TUD_EPOCHS + 1):
        it = iter(train_loader)
        epoch_losses = []
        while True:
            t0 = time.perf_counter()
            gb = next(it, None)
            t1 = time.perf_counter()
            if gb is None:
                break
            before = read_counts()
            epoch_losses.append(float(step(gb)))   # waits for the step
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            loader_ms.append((t1 - t0) * 1e3)
            for k, v in launched_since(before).items():
                launches[k] += v
            n_batches += 1
        losses.append(float(np.mean(epoch_losses)))
        if epoch % 5 == 0 or epoch == 1:
            history.append((epoch, evaluate(train_loader),
                            evaluate(test_loader)))
            log(f"  epoch {epoch:3d}  loss {epoch_losses[-1]:.4f}  train "
                f"{history[-1][1]:.3f}  test {history[-1][2]:.3f}")
    log(f"  {n_batches} batches: ms/batch median "
        f"{statistics.median(batch_ms):.3f} (the loader's host ms/batch "
        f"{statistics.median(loader_ms):.3f}); mean loss of epoch 1 "
        f"{losses[0]:.4f}, of epoch {EX_TUD_EPOCHS} {losses[-1]:.4f}")
    log(f"  launches over {n_batches} batches: {launches}")
    expect_counts("3s graph classification", launches, {"k1": 3},
                  steps=n_batches)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"3s: the loss did not fall: {losses}")
    res = {"batches": n_batches, "losses": losses, "accuracy": history,
           "ms_per_batch": batch_ms, "loader_ms": loader_ms,
           "median_ms_per_batch": statistics.median(batch_ms),
           "median_loader_ms": statistics.median(loader_ms),
           "launches": launches, "train_acc": history[-1][1],
           "test_acc": history[-1][2]}
    batches = list(train_loader)
    cycle = iter(batches * 3)
    res["profile"] = profile_calls(lambda: step(next(cycle)), None)

    def empty(gb):
        return int((gb.indptr_g[1:] == gb.indptr_g[:-1]).sum())

    short = max(batches, key=empty)
    res["fillers_in_checked_batch"] = empty(short)
    log(f"phase 3s (3c): a short batch ({short.num_graphs} graphs, "
        f"{empty(short)} of them empty fillers) on the card vs the CPU plain "
        "path in float64")

    def forward(m, gg, xx, extra):
        logits = m(gg, xx)
        return logits, graph_loss(logits, gg)

    before = read_counts()
    res["vs_cpu"] = compare_model("graph classification (3s)", model, short,
                                  short.x, None, forward=forward)
    expect_launched("graph classification (3s)", before, {"k1": 3})
    return res


# ---- phases 2k, 3t and 3u: the multi-device path ---------------------------

# benchmarks/scaling.py's defaults (:64-76, :120-140): the community graph,
# N = 65,536, E = 1,000,000, D = 128, the bfs partitioner, 10 chained steps
PAR_N, PAR_E, PAR_STEPS = 65_536, 1_000_000, 10
# 3t's parts and their backends. Every rank runs on the one card; nccl
# refuses two ranks on one device, so P > 1 runs on gloo, which takes the
# CUDA tensors itself (it stages them through the host: checked on an H100
# before this phase was written). P = 1 runs on nccl.
PAR_BACKEND = {1: "nccl", 2: "gloo", 4: "gloo"}
# 3u: __graft_entry__.py's (data x graph) mesh at 4 ranks, two community
# graphs (seeds 0 and 1), 8 classes; the checkpoint after step 5
PAR_MESH = (2, 2)
PAR_CKPT_STEP = 5
PAR_LR = 1e-3
# a spawn's limit: the ranks start together, build their views and run;
# a hang in a collective fails the phase here
PAR_TIMEOUT_S = 300
# 3u, the mesh against one card training the same model, both float32 on
# the card. The losses: each is a mean of 2N = 131,072 terms ~2.1 summed in
# another order (a part's sum, then the all_reduce), each side's rounding
# ~eps * sqrt(2N) ~ 4e-5 relative at worst for the sum and 1e-7 for a
# pairwise one; held to 1e-5, 10x what a few-ulp difference in the logits
# moves. The parameters: Adam's update m / sqrt(v) is ~lr a component
# whatever the gradient's size, so a component whose gradient lies within
# float32 rounding of 0 (|g| < ~2e-5 of its scale: ~1.6e-5 of 34k
# components a step, ~5 in 10 steps) may step the other way on the other
# side: 2 lr apart. Against the total update's norm (~lr * 10 * sqrt(34k)
# ~ 1,800 lr) each such component is ~1e-3; held to 1e-2 (~100 of them).
PAR_LOSS_RTOL = 1e-5
PAR_PARAM_RTOL = 1e-2


def community_graph(n: int, e: int, seed: int = 0):
    """Host edge list (senders, receivers) of ``benchmarks/scaling.py``'s
    ``community`` family: a copy of its ``make_graph`` (:34-61) for that
    family (64 hidden communities, 80 % intra edges, ids shuffled)."""
    rng = np.random.default_rng(seed)
    ncomm, p_intra = 64, 0.8
    comm = rng.permutation(n) % ncomm            # hidden, id-shuffled
    members = [np.nonzero(comm == c)[0] for c in range(ncomm)]
    s = rng.integers(0, n, e, dtype=np.int64)
    r = rng.integers(0, n, e, dtype=np.int64)
    intra = rng.random(e) < p_intra
    cs = comm[s]
    for c in range(ncomm):
        m = intra & (cs == c)
        if m.any():
            r[m] = rng.choice(members[c], int(m.sum()))
    return s.astype(np.int32), r.astype(np.int32)


def par_features(seed: int, n: int | None = None):
    """``x [n, D]`` float32 and ``n`` (default ``PAR_N``) labels of
    ``OUT_D`` classes."""
    n = PAR_N if n is None else n
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D), dtype=np.float32),
            rng.integers(0, OUT_D, n))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, nprocs, backend, dev, port, out_dir, args):
    """A spawned rank: ``fn``'s result and the wall-clock times (host
    clock, ``time.time``) at which the rank entered, joined its group and
    finished, saved for :func:`spawn_ranks`."""
    import datetime

    import torch.distributed as dist

    times = [time.time()]
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent's
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=nprocs,
        rank=rank, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        times.append(time.time())
        out = fn(rank, nprocs, dev, *args)
        times.append(time.time())
        torch.save((out, times), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, backend: str, dev, *args) -> list:
    """``fn(rank, nprocs, dev, *args)`` in ``nprocs`` processes (the
    ``spawn`` start method), each on ``dev`` (the card: device 0) with
    ``init_process_group(backend)`` on a free localhost port; their results
    in rank order. A rank that
    raises fails the phase; ranks still running after
    :data:`PAR_TIMEOUT_S` are killed and fail it too."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        ctx = mp.start_processes(
            _rank_entry, args=(fn, nprocs, backend, str(dev), _free_port(),
                               out_dir, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + PAR_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{nprocs} ranks did not finish "
                                         f"in {PAR_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(nprocs)]
    log(f"  {nprocs} rank(s) of {fn.__name__}: started (spawn and imports) "
        f"{max(t[0] for _, t in got) - t0:.1f} s after the spawn, joined "
        f"their group {max(t[1] - t[0] for _, t in got):.1f} s later, ran "
        f"{max(t[2] - t[1] for _, t in got):.1f} s; "
        f"{time.time() - t0:.1f} s in all (the slowest rank each)")
    return [out for out, _ in got]


def device_split(prof, steps: int) -> tuple[float, float]:
    """``(device ms, of it copies between host and card)`` per step of a
    profiler run of ``steps`` steps (gloo stages CUDA tensors through the
    host: its copies are device time that no kernel spends)."""
    rows = device_rows(prof, steps)
    return (sum(ms for ms, _, _ in rows),
            sum(ms for ms, _, key in rows if key.startswith("Memcpy")))


def propagate_rank(rank, nprocs, dev, s, r, parts) -> dict:
    """3t on one rank: its part of ``make_sharded_propagate`` over the
    split path (the default) and the combined one: one step's output, then
    :data:`PAR_STEPS` chained steps (``y = run(y) * 1e-3``, as scaling.py
    chains them) after two warm-up steps, timed on the host from a barrier
    to a synchronise, with their K1 launches; then 3 steps profiled (the
    device time and its copies, per step)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile as tprofile

    import graphneuralnetworks_tpu_torch as gnn
    from graphneuralnetworks_tpu_torch import parallel as par

    n = len(parts)
    g = gnn.graph(s, r, num_nodes=n, device=dev)
    mesh = par.Mesh((nprocs,), ("graph",))
    pg = par.partition_graph(g, nprocs, parts=parts)
    run = par.make_sharded_propagate(mesh, pg, device=dev)
    x = pg.scatter_nodes(torch.as_tensor(par_features(0, n)[0],
                                         device=dev))[rank]
    out = {"owned": pg.owned[rank], "src_rows": run.graph.src_rows,
           "rem_rows": run.graph.split.halo.rows}
    for path, sg in (("split", run.graph),
                     ("combined", run.graph.replace(split=None))):
        out[f"{path}_y"] = par.halo_propagate_local(x, sg).cpu()
        v = x
        for _ in range(2):
            v = par.halo_propagate_local(v, sg) * 1e-3
        _sync(dev)
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        v = x
        for _ in range(PAR_STEPS):
            v = par.halo_propagate_local(v, sg) * 1e-3
        _sync(dev)
        out[f"{path}_ms"] = (time.perf_counter() - t0) * 1e3 / PAR_STEPS
        out[f"{path}_launches"] = read_counts()
        dist.barrier()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with tprofile(activities=acts) as prof:
            v = x
            for _ in range(3):
                v = par.halo_propagate_local(v, sg) * 1e-3
            _sync(dev)
        out[f"{path}_device_ms"], out[f"{path}_copy_ms"] = device_split(
            prof, 3)
        dist.barrier()
    return out


def par_model(M, name: str, dev, seed: int = 0):
    """3u's models: 3a's GCN, and __graft_entry__.py's dryrun chain at this
    width (``GCNConv(128, 128, relu)``, ``GATConv(128, 128, heads=2,
    concat=False)``, ``Linear(128, 8)``), from ``seed``."""
    if name == "gcn":
        return gcn(M, seed, dev)
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    return M.GNNChain(
        M.GCNConv(D, D, torch.relu, generator=gen, device=dev),
        M.GATConv(D, D, heads=2, concat=False, generator=gen, device=dev),
        torch.nn.Linear(D, OUT_D).to(dev))


def nll_sum(logits, y):
    return -torch.log_softmax(logits, -1).gather(
        -1, y.long()[:, None]).sum()


def par_local_loss(m, sg, x, y):
    """A part's summed negative log-likelihood over its owned nodes and
    their count (the dryrun's ``local_loss``)."""
    return nll_sum(m(sg, x), y), sg.node_mask.sum().to(x.dtype)


# K1, K3, K4, K5 launches a step on one rank of 3u, and a step of one card
# per graph it trains on: GCNConv(128, 128) propagates before its weight
# and its input needs no gradient (1 K1); GCNConv(128, 8) propagates after
# it (1 K1 forward, 1 for x's gradient over the sender CSR); GATConv one
# K3, K4, K5. On the mesh every exchange that a gradient flows back through
# adds fast_gather's K1 over the shipped rows: GCN's second layer 1, GAT's
# pj and values 2.
PAR_PER_STEP = {"gcn": ({"k1": 4}, {"k1": 3}),
                "chain": ({"k1": 3, "k3": 1, "k4": 1, "k5": 1},
                          {"k1": 1, "k3": 1, "k4": 1, "k5": 1})}


def mesh_train_rank(rank, nprocs, dev, graphs, parts, names,
                    base_dir) -> dict:
    """3u on one rank, for each model of ``names`` in turn
    (:func:`mesh_train_model`) on one partition of the graphs; the results
    by model."""
    import graphneuralnetworks_tpu_torch as gnn
    from graphneuralnetworks_tpu_torch import parallel as par

    n = len(parts[0])
    mesh = par.Mesh(PAR_MESH, ("data", "graph"))
    pgs = [par.partition_graph(gnn.graph(s, r, num_nodes=n, device=dev),
                               PAR_MESH[1], parts=p)
           for (s, r), p in zip(graphs, parts)]
    d, part = mesh.index("data"), mesh.index("graph")
    x, y = (torch.as_tensor(a, device=dev) for a in par_features(10 + d, n))
    x, y = pgs[d].scatter_nodes(x)[part], pgs[d].scatter_nodes(y)[part]
    return {name: mesh_train_model(
        rank, dev, mesh, pgs, x, y, graphs, name,
        os.path.join(base_dir, f"3u_{name}_ckpt"),
        os.path.join(base_dir, f"3u_{name}_trace")) for name in names}


def mesh_train_model(rank, dev, mesh, pgs, x, y, graphs, name, ckpt_dir,
                     trace_dir) -> dict:
    """3u's model ``name`` on one rank: ``make_mesh_train_step`` on the
    (data x graph) mesh, :data:`PAR_STEPS` Adam steps timed by
    ``profiling.StepTimer``, a checkpoint after step :data:`PAR_CKPT_STEP`
    (rank 0 writes it), then fresh modules and optimizer restored from it
    and the steps after it again; last, three more steps under
    ``profiling.trace``."""
    import torch.distributed as dist

    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch import parallel as par
    from graphneuralnetworks_tpu_torch import profiling
    from graphneuralnetworks_tpu_torch.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)

    def trainer(seed):
        model = par_model(M, name, dev, seed)
        opt = torch.optim.Adam(model.parameters(), lr=PAR_LR)
        return model, opt, par.make_mesh_train_step(
            model, opt, mesh, pgs, par_local_loss, device=dev)

    model, opt, step = trainer(0)
    timer = profiling.StepTimer(
        num_edges=sum(len(s) for s, _ in graphs), device=dev)
    losses = []
    _sync(dev)
    reset_counts()
    for i in range(PAR_STEPS):
        with timer:
            losses.append(float(step(x, y)))
        if i + 1 == PAR_CKPT_STEP:
            if rank == 0:
                save_checkpoint(ckpt_dir, PAR_CKPT_STEP,
                                {"model": model, "opt": opt})
            dist.barrier()
    launches = read_counts()
    final = {k: p.detach().to("cpu", copy=True)
             for k, p in model.named_parameters()}
    model2, opt2, _ = trainer(1)
    restore_checkpoint(ckpt_dir, {"model": model2, "opt": opt2})
    step2 = par.make_mesh_train_step(model2, opt2, mesh, pgs,
                                     par_local_loss, device=dev)
    resumed = [float(step2(x, y)) for _ in range(PAR_STEPS - PAR_CKPT_STEP)]
    same = resumed == losses[PAR_CKPT_STEP:] and all(
        torch.equal(p.detach().cpu(), final[k])
        for k, p in model2.named_parameters())
    with profiling.trace(os.path.join(trace_dir, f"rank{rank}")) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(x, y)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / 3
    device, copies = device_split(prof, 3)
    return {"losses": losses, "resumed": resumed, "resume_same": same,
            "final": final, "launches": launches, "step_s": timer.history,
            "report": timer.report(), "profiled_wall_ms": wall,
            "device_ms": device, "copy_ms": copies,
            "trace_bytes": os.path.getsize(prof.trace_path),
            "n_owned": int(x.shape[0]), "src_rows": step.graph.src_rows}


def shard_gat_cases(res, card, label, lg, h, d, gen) -> None:
    """K3, K4 and K5 on a part's view ``lg`` (its receiver CSR over the
    owned rows, its sender CSR over the halo buffer) at ``(h, d)``, each
    held to its plain version and timed, as phase 2b holds them on one
    graph: per-node scalars and value rows of the receivers (``n_dst``)
    and of the buffer's senders (``n_src``) are counted apart."""
    from graphneuralnetworks_tpu_torch.ops.cuda import edge_softmax as ES

    dev = lg.indptr_r.device
    ir, cr, is_, cs = lg.indptr_r, lg.col_r, lg.indptr_s, lg.col_s
    n_dst, n_src, e = lg.num_nodes, lg.indptr_s.numel() - 1, lg.num_edges

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    pi, pj, v, dy = rn(n_dst, h), rn(n_src, h), rn(n_src, h, d), \
        rn(n_dst, h, d)
    sl, sv = rn(n_dst, h), rn(n_dst, h, d)
    hd = f"{label} H={h} D={d}"
    # compulsory bytes, float32 and int32: a CSR's indptr and col; per-node
    # scalars (h each) and value rows (h*d each) of receivers and senders;
    # outputs once. The no-reuse bound adds the per-edge gathers' re-reads.
    idx_r, idx_s = 4 * (n_dst + 1 + e), 4 * (n_src + 1 + e)
    dst, src = 4 * h * n_dst, 4 * h * n_src
    dst_rows, src_rows = d * dst, d * src
    src_again = 4 * e * h * (d + 1) - src_rows - src
    dst_again = 4 * e * h * (d + 4) - dst_rows - 4 * dst
    num, m, s_ = kernel_case(
        res, card, "k3", hd, ES.gat_softmax, ES.gat_softmax_plain,
        (ir, cr, pi, pj, v, 0.2), idx_r + dst + src + src_rows + dst_rows
        + 2 * dst, e * h * (2 * d + 6), src_again)
    out, mx, den = ES.finalize_softmax(num, m, s_, sl, sv)
    bwd = (pi, pj, v, mx, den, (out * dy).sum(-1), dy, 0.2)
    # in: pi, mx, den, s_n and dy of the receivers, pj and v of the
    # senders; out: dpi (K4) or dpj and dv (K5)
    ins = 4 * dst + src + dst_rows + src_rows
    kernel_case(res, card, "k4", hd, ES.gat_bwd_dpi, ES.gat_bwd_dpi_plain,
                (ir, cr) + bwd, idx_r + ins + dst, e * h * (2 * d + 10),
                src_again)
    kernel_case(res, card, "k5", hd, ES.gat_bwd_rev, ES.gat_bwd_rev_plain,
                (is_, cs) + bwd, idx_s + ins + src + src_rows,
                e * h * (4 * d + 10), dst_again)


def shard_kernel_cases(kern, card, pgs, dev) -> None:
    """2k: the kernels of 3t and 3u at the shapes their parts give them,
    each held to its plain version (K1 also to ``torch.sparse.mm`` over the
    same CSR) and timed. 3t, P = 4: every part's combined receiver CSR
    (its owned rows over its halo buffer) and part 0's owned and remote
    halves of the split path, at D = 128. 3u, P = 2 (graph 0's partition,
    part 0): the receiver CSR at D = 128 (both models' first layer) and 8
    (GCN's second), the sender CSR at 8 (that layer's x gradient), the
    backward of the gather of its shipped rows (``fast_gather`` over their
    grouping by node) at 8 (GCN), 2 (GATConv's pj) and 256 (its values),
    and K3, K4, K5 at GATConv's (H, D) = (2, 128)."""
    from graphneuralnetworks_tpu_torch.graph import group_by
    from graphneuralnetworks_tpu_torch.parallel.shardgraph import local_graph

    gen = torch.Generator(device=dev).manual_seed(41)

    def case(label, paths, indptr, col, eid, n_src, d=D):
        n_rows = indptr.numel() - 1
        src = torch.randn(n_src, d, generator=gen, device=dev)
        a = torch.sparse_csr_tensor(
            indptr, col, torch.ones(col.numel(), device=dev),
            (n_rows, n_src))
        k1_timed_case(kern, card, label, paths, (indptr, col, eid, None, src),
                      lambda: torch.sparse.mm(a, src))

    def view(pg, p):
        n_own, rows = len(pg.owned[p]), pg.buffer_rows(p)
        return local_graph(pg.recv_local[p], pg.send_buf[p], n_own, rows,
                           device=dev)

    pg = pgs[4]
    for p in range(pg.num_parts):
        lg = view(pg, p)
        case(f"3t P=4 part {p} fwd receiver-CSR D=128 ({lg.num_nodes} rows "
             f"from {lg.indptr_s.numel() - 1})", "3t combined path",
             lg.indptr_r, lg.col_r, None, lg.indptr_s.numel() - 1)
    n_own = len(pg.owned[0])
    own = local_graph(pg.own_recv[0], pg.own_send[0], n_own, n_own,
                      device=dev)
    case("3t P=4 part 0 split own fwd D=128", "3t split path (owned half)",
         own.indptr_r, own.col_r, None, n_own)
    n_rem = sum(len(pg.halo[q][0]) for q in range(1, pg.num_parts))
    rem = local_graph(pg.rem_recv[0], pg.rem_send[0], n_own, n_rem,
                      device=dev)
    case(f"3t P=4 part 0 split remote fwd D=128 (from {n_rem})",
         "3t split path (remote half)", rem.indptr_r, rem.col_r, None, n_rem)

    pg = pgs[PAR_MESH[1]]
    lg = view(pg, 0)
    n_own, rows = lg.num_nodes, lg.indptr_s.numel() - 1
    for d, paths in ((D, "3u layers (fwd at 128)"),
                     (OUT_D, "3u GCN's second layer (fwd)")):
        case(f"3u P=2 part 0 fwd receiver-CSR D={d} ({n_own} rows from "
             f"{rows})", paths, lg.indptr_r, lg.col_r, None, rows, d)
    case(f"3u P=2 part 0 bwd sender-CSR D={OUT_D} ({rows} rows from "
         f"{n_own})", "3u GCN's second layer (x's gradient)", lg.indptr_s,
         lg.col_s, lg.eid_s, n_own, OUT_D)
    send = torch.as_tensor(np.concatenate(
        [pg.halo[0][q] for q in range(pg.num_parts)]), device=dev)
    _, order, indptr = group_by(send, n_own)
    for d, paths in ((OUT_D, "3u GCN exchange backward"),
                     (2, "3u GAT pj exchange backward"),
                     (2 * D, "3u GAT values exchange backward")):
        case(f"3u P=2 part 0 halo gather bwd D={d} ({send.numel()} shipped "
             "rows)", f"{paths} (fast_gather)", indptr, order.int(), None,
             send.numel(), d)
    for key in ("k3", "k4", "k5"):
        kern.setdefault(key, {"err": 0.0, "variants": []})
    shard_gat_cases(kern, card, "3u P=2 part 0", lg, 2, D, gen)


def multi_device_phases(gnn, card, which, out_dir,
                        dev=torch.device("cuda")) -> tuple:
    """2k, 3t and 3u (those of ``which``) on ``dev``. Returns the results
    and 2k's cases by kernel (K1, K3, K4, K5)."""
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch import parallel as par
    from graphneuralnetworks_tpu_torch.training import make_train_step

    res, kern = {}, {"k1": {"err": 0.0, "variants": []}}
    t0 = time.perf_counter()
    s, r = community_graph(PAR_N, PAR_E, seed=0)
    g = gnn.graph(s, r, num_nodes=PAR_N, device=dev)
    parts = {p: par.partition_nodes(s, r, PAR_N, p) for p in PAR_BACKEND}
    log(f"phases 2k/3t/3u set-up: community graph N={PAR_N} E={PAR_E} "
        f"(benchmarks/scaling.py:34-61), partition_nodes for P = "
        f"{list(parts)}: {time.perf_counter() - t0:.2f} s")
    pgs = {p: par.partition_graph(g, p, parts=parts[p]) for p in parts}
    if "2k" in which:
        log("phase 2k: K1 at the shapes of 3t's P = 4 parts and 3u's P = 2 "
            "part vs the plain version and torch.sparse.mm; K3-K5 at 3u's "
            "GATConv shapes vs their plain versions")
        shard_kernel_cases(kern, card, pgs, dev)
        log_times(kern, 66)
    if "3t" in which:
        log(f"phase 3t: make_sharded_propagate on the community graph, D = "
            f"{D}, P = {list(PAR_BACKEND)} (backends {PAR_BACKEND}); all "
            "ranks share the one card, so these times are of several ranks "
            "on one card, not scaling figures; gloo ships CUDA tensors "
            "through the host itself")
        x = torch.as_tensor(par_features(0)[0], device=dev)
        y_ref = gnn.ops.propagate(gnn.ops.copy_xj, g, "sum", xj=x)
        res["3t"] = {}
        for p, backend in PAR_BACKEND.items():
            ranks = spawn_ranks(propagate_rank, p, backend, dev, s, r,
                                parts[p])
            pg, row = pgs[p], {"backend": backend}
            for path, per_step in (("split", 2), ("combined", 1)):
                y = pg.gather_nodes([v[f"{path}_y"] for v in ranks])
                row[f"{path}_err"] = compare(
                    f"3t P={p} {path} vs one card", y.to(dev), y_ref)
                for i, v in enumerate(ranks):
                    expect_counts(f"3t P={p} {path} rank {i}",
                                  v[f"{path}_launches"], {"k1": per_step},
                                  steps=PAR_STEPS)
                row[f"{path}_ms"] = max(v[f"{path}_ms"] for v in ranks)
                row[f"{path}_ms_by_rank"] = [v[f"{path}_ms"] for v in ranks]
                for key in ("device_ms", "copy_ms"):
                    row[f"{path}_{key}"] = sum(v[f"{path}_{key}"]
                                               for v in ranks)
            row.update(cut_fraction=pg.cut_fraction,
                       halo_bytes=pg.halo_bytes_per_step(D),
                       owned=[len(o) for o in pg.owned],
                       buffer_rows=[v["src_rows"] for v in ranks],
                       remote_rows=[v["rem_rows"] for v in ranks])
            log(f"  P={p} ({backend}): split {row['split_ms']:.3f} ms/step, "
                f"combined {row['combined_ms']:.3f} ms/step (slowest rank "
                f"of {p} on one card, {PAR_STEPS} chained steps); cut "
                f"fraction {row['cut_fraction']:.4f}, halo "
                f"{row['halo_bytes']} bytes/exchange; owned "
                f"{row['owned']}, buffer rows {row['buffer_rows']}, remote "
                f"{row['remote_rows']}; K1 per rank a step: split 2, "
                "combined 1")
            for path in ("split", "combined"):
                dm, cm = row[f"{path}_device_ms"], row[f"{path}_copy_ms"]
                log(f"    {path}, 3 steps profiled on every rank: the ranks' "
                    f"device time {dm:.3f} ms/step, of it gloo's copies "
                    f"between host and card {cm:.3f} and kernels "
                    f"{dm - cm:.3f}; busy {100 * dm / row[f'{path}_ms']:.1f}"
                    f" % of the step (kernels "
                    f"{100 * (dm - cm) / row[f'{path}_ms']:.1f} %)")
            res["3t"][p] = row
    if "3u" in which:
        graphs = [community_graph(PAR_N, PAR_E, seed=i)
                  for i in range(PAR_MESH[0])]
        mparts = [par.partition_nodes(a, b, PAR_N, PAR_MESH[1])
                  for a, b in graphs]
        res["3u"] = mesh_train_phases(gnn, M, make_train_step, dev, graphs,
                                      mparts, ("gcn", "chain"), out_dir)
    return res, kern


def mesh_train_phases(gnn, M, make_train_step, dev, graphs, parts, names,
                      out_dir) -> dict:
    """3u for each model of ``names``: one forward+backward on the card is
    held to the CPU plain path in float64 and one card trains it on both
    graphs (the global mean loss) (:func:`mesh_reference`); then the mesh
    of 4 ranks trains every model in turn, in one spawn of the ranks
    (:func:`mesh_train_rank`); losses, parameters, launches, the resume and
    the trace are checked per model (:func:`mesh_check`)."""
    import tempfile

    refs = {name: mesh_reference(gnn, M, make_train_step, dev, graphs, name)
            for name in names}
    log(f"phase 3u: make_mesh_train_step on a (data {PAR_MESH[0]} x graph "
        f"{PAR_MESH[1]}) mesh of {PAR_MESH[0] * PAR_MESH[1]} gloo ranks on "
        f"the one card, two community graphs, {PAR_STEPS} Adam steps of "
        f"each of {list(names)} in one spawn of the ranks")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(mesh_train_rank, PAR_MESH[0] * PAR_MESH[1],
                            "gloo", dev, graphs, parts, names, out_dir or tmp)
    return {name: mesh_check(name, refs[name], [v[name] for v in ranks])
            for name in names}


def mesh_reference(gnn, M, make_train_step, dev, graphs, name) -> dict:
    """3u's model ``name`` on one card: one forward+backward on graph 0
    held to the CPU plain path in float64, then :data:`PAR_STEPS` Adam
    steps on both graphs' global mean loss, with their launches, the run
    the mesh is held to."""
    log(f"phase 3u ({name}): one card trains the model the mesh trains on "
        f"the same two community graphs, {PAR_STEPS} Adam steps")
    gs = [gnn.graph(s, r, num_nodes=PAR_N, device=dev) for s, r in graphs]
    data = [tuple(torch.as_tensor(a, device=dev) for a in par_features(10 + i))
            for i in range(len(gs))]
    model = par_model(M, name, dev)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}

    def graph0_loss(m, gg, xx, extra):
        logits = m(gg, xx)
        return logits, nll_sum(logits, data[0][1].to(logits.device)) / PAR_N

    log("  one forward+backward on graph 0, the card (its kernels) vs the "
        "CPU plain path in float64: the one-card run that the mesh is held "
        "to below")
    vs_cpu = compare_model(f"3u {name}", model, gs[0], data[0][0], None,
                           forward=graph0_loss)
    opt = torch.optim.Adam(model.parameters(), lr=PAR_LR)

    def loss_fn(m):
        return sum(nll_sum(m(g, x), y) for g, (x, y) in zip(gs, data)) \
            / (PAR_N * len(gs))

    step = make_train_step(model, opt, loss_fn)
    _sync(dev)
    reset_counts()
    ref_losses, ref_ms = [], []
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        ref_losses.append(float(step()))
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    per_graph = PAR_PER_STEP[name][1]
    card_per_step = {k: v * len(gs) for k, v in per_graph.items()}
    expect_counts(f"3u {name} one card", read_counts(), card_per_step)
    return {"model": model, "init": init, "vs_cpu": vs_cpu,
            "losses": ref_losses, "ms": ref_ms,
            "card_per_step": card_per_step}


def mesh_check(name, ref, ranks) -> dict:
    """3u's model ``name``: the mesh's ranks (:func:`mesh_train_model`)
    against each other and against the one card's run ``ref``
    (:func:`mesh_reference`): launches, losses, parameters, the resume and
    the traces; logged and returned."""
    model, init, ref_losses = ref["model"], ref["init"], ref["losses"]
    mesh_per_step, card_per_step = PAR_PER_STEP[name][0], ref["card_per_step"]
    losses = ranks[0]["losses"]
    for i, v in enumerate(ranks):
        expect_counts(f"3u {name} rank {i}", v["launches"], mesh_per_step)
        if v["losses"] != losses:
            raise AssertionError(f"3u {name}: rank {i}'s losses "
                                 f"{v['losses']} differ from rank 0's")
        for k, t in v["final"].items():
            if not torch.equal(t, ranks[0]["final"][k]):
                raise AssertionError(f"3u {name}: rank {i}'s {k} differs")
        if not v["resume_same"]:
            raise AssertionError(f"3u {name}: rank {i} resumed from step "
                                 f"{PAR_CKPT_STEP} to {v['resumed']}, not "
                                 f"{v['losses'][PAR_CKPT_STEP:]} bit for bit")
        if v["trace_bytes"] <= 0:
            raise AssertionError(f"3u {name}: rank {i}'s trace is empty")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"3u {name}: loss did not fall: {losses}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if loss_err > PAR_LOSS_RTOL:
        raise AssertionError(f"3u {name}: losses {losses} vs one card "
                             f"{ref_losses} (rel {loss_err:.3e})")
    final = {k: p.detach() for k, p in model.named_parameters()}
    dev = next(iter(final.values())).device
    diff = torch.sqrt(sum(((ranks[0]["final"][k].to(dev) - final[k]) ** 2)
                          .sum() for k in final))
    moved = torch.sqrt(sum(((final[k] - init[k]) ** 2).sum()
                           for k in final))
    param_err = float(diff / moved)
    if not param_err <= PAR_PARAM_RTOL:
        raise AssertionError(f"3u {name}: parameters {param_err:.3e} of "
                             f"their update's norm from one card's")
    ms = [1e3 * t for t in ranks[0]["step_s"]]
    busy = sum(v["device_ms"] for v in ranks)
    copies = sum(v["copy_ms"] for v in ranks)
    wall = max(v["profiled_wall_ms"] for v in ranks)
    log(f"  3u {name}: loss {losses[0]:.6f} -> {losses[-1]:.6f} (one card "
        f"{ref_losses[0]:.6f} -> {ref_losses[-1]:.6f}; max rel "
        f"{loss_err:.3e}, rtol {PAR_LOSS_RTOL:g}); parameters after "
        f"{PAR_STEPS} steps {param_err:.3e} of the update's norm (tol "
        f"{PAR_PARAM_RTOL:g})")
    log(f"  StepTimer (CUDA events, rank 0; 4 ranks share the card): "
        f"{ranks[0]['report']}; ms/step {[round(t, 3) for t in ms]}; one "
        f"card median {statistics.median(ref['ms']):.3f} ms/step")
    log(f"  profiled 3 steps: wall {wall:.3f} ms/step; the 4 ranks' device "
        f"time {busy:.3f} ms/step (by rank "
        f"{[round(v['device_ms'], 3) for v in ranks]}), of it gloo's "
        f"copies between host and card {copies:.3f} and kernels "
        f"{busy - copies:.3f}; busy {100 * busy / wall:.1f} % (kernels "
        f"{100 * (busy - copies) / wall:.1f} %); traces "
        f"{[v['trace_bytes'] for v in ranks]} bytes")
    log(f"  launches a step per rank {mesh_per_step}, one card "
        f"{card_per_step}; resume from step {PAR_CKPT_STEP}: steps "
        f"{PAR_CKPT_STEP + 1}-{PAR_STEPS} bit for bit on every rank")
    return {"losses": losses, "card_losses": ref_losses,
            "vs_cpu": ref["vs_cpu"],
            "loss_rel_err": loss_err, "param_rel_err": param_err,
            "ms_per_step_rank0": ms, "report": ranks[0]["report"],
            "card_ms_per_step": ref["ms"], "profiled_wall_ms": wall,
            "device_ms_per_step": busy, "copy_ms_per_step": copies,
            "device_ms_by_rank": [v["device_ms"] for v in ranks],
            "launches_per_rank": [v["launches"] for v in ranks],
            "owned": [v["n_owned"] for v in ranks],
            "buffer_rows": [v["src_rows"] for v in ranks],
            "trace_bytes": [v["trace_bytes"] for v in ranks]}


def cora_phase(dev) -> dict:
    from graphneuralnetworks_tpu_torch import models as M
    from graphneuralnetworks_tpu_torch.data import load_cora
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
        if name == "GAT":
            return M.GNNChain(M.GATConv(din, nh, torch.relu, heads=2, **kw),
                              M.GATConv(2 * nh, nh, torch.relu, heads=2,
                                        concat=False, **kw), head)
        if name == "GATv2":
            return M.GNNChain(
                M.GATv2Conv(din, nh, torch.relu, heads=2, **kw),
                M.GATv2Conv(2 * nh, nh, torch.relu, heads=2, concat=False,
                            **kw), head)
        if name == "ResGated":      # tests/test_integration_cora.py:65-69
            return M.GNNChain(
                M.ResGatedGraphConv(din, nh, torch.relu, **kw),
                M.ResGatedGraphConv(nh, nh, torch.relu, **kw), head)
        if name == "Transformer":   # tests/test_integration_cora.py:70-74
            return M.GNNChain(
                M.TransformerConv(din, nh, heads=2, concat=False, **kw),
                M.TransformerConv(nh, nh, heads=2, concat=False, **kw), head)
        return M.GNNChain(M.GINConv(M.MLP([din, nh], **kw), 0.01),
                          M.GINConv(M.MLP([nh, nh], **kw), 0.01), head)

    out = {"real_dataset": is_real}
    for name in ("GCN", "GraphConv", "SAGE", "GIN", "GAT", "GATv2",
                 "ResGated", "Transformer"):
        torch.manual_seed(17)
        model = build(name, torch.Generator().manual_seed(17))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = make_train_step(
            model, opt,
            lambda m, g, x, y, mask: masked_cross_entropy(m(g, x), y, mask))
        reset_counts()
        for _ in range(CORA_EPOCHS):
            step(g, x, y, data.train_mask)
        launches = read_counts()
        with torch.no_grad():
            logits = model(g, x)
        tr = float(masked_accuracy(logits, y, data.train_mask))
        te = float(masked_accuracy(logits, y, data.test_mask))
        log(f"  {name:<10} train acc {tr:.4f} test acc {te:.4f} "
            f"launches {launches}")
        if not (tr > 0.94 and te > 0.69):
            raise AssertionError(f"{name}: Cora bar missed (train {tr}, "
                                 f"test {te})")
        kernel = {"GAT": "k3", "GATv2": "k9", "Transformer": "k6"}.get(
            name, "k1")
        if launches[kernel] == 0:
            raise AssertionError(f"{name}: {kernel.upper()} never launched")
        out[name] = {"train_acc": tr, "test_acc": te, "launches": launches}
    return out


# ---- main ------------------------------------------------------------------

def tud_batch(gnn, dev):
    """The 3k batch: ``synthetic_tudataset(TUD_GRAPHS)`` built on the host
    and joined by ``batch`` onto the card, with the host's time for each."""
    t0 = time.perf_counter()
    graphs, _ = gnn.data.synthetic_tudataset(TUD_GRAPHS, seed=0,
                                             device="cpu")
    t1 = time.perf_counter()
    gb = gnn.batch(graphs, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  3k batch: synthetic_tudataset({TUD_GRAPHS}) {t1 - t0:.2f} s, "
        f"batch {t2 - t1:.2f} s on the host ({gb.num_nodes} nodes, "
        f"{gb.num_edges} edges)")
    return gb, {"dataset_s": t1 - t0, "batch_s": t2 - t1,
                "num_nodes": gb.num_nodes, "num_edges": gb.num_edges}



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (and the trace)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the train step")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run phase 1 and only these phases, in this order "
                         "(comma-separated, of 2,2b,2c,2d,2e,2f,2h,2l and "
                         "the train phases 3b, 3d, 3e, 3f, 3l, 3v, 3o, 3p, "
                         "3q, 3s, 3x, "
                         "3m, 3n and 3w, 2j and 3r, and 2k, 3t and 3u; 3p "
                         "and 3q run 2i's cases with them; 2k, 3t and 3u "
                         "run after the others (on one partition), then 2j "
                         "and 3r (on one edge split), 3m, 3n and 3w last, "
                         "with 2g for 3m and 3n and 2l's cases on a 3n "
                         "draw), then stop without a result line")
    ap.add_argument("--sweep", nargs="?", const=",".join(SWEEPS),
                    default=None, metavar="NAMES",
                    help="after phase 2, time K1-K12, K14 and its "
                         "backward at every "
                         "layout, K1's gather-rate ceiling, and the R-MAT "
                         "graph (skew); NAMES (comma-separated, of "
                         f"{','.join(SWEEPS + SWEEP_PARTS)}) runs those "
                         "only")
    ap.add_argument("--cells", default=None, metavar="KEYS",
                    help="with --only 3o: run only these 3o cells (by "
                         "result key, comma-separated, e.g. "
                         "transformer_bf16,agnn_bf16), timed and profiled "
                         "without the card-vs-CPU step, --repeat times "
                         "each")
    ap.add_argument("--repeat", type=int, default=1,
                    help="with --cells: train each cell this many times "
                         "in turn, for the spread of its host median")
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
        log_ptxas(name, text)
    for name in ("spmm", "edge_softmax"):
        if name in B.build_logs():
            log_dot_bf16_ptxas(B.build_logs()[name])

    t0 = time.perf_counter()
    g = gnn.rand_graph(N, E, seed=1)
    torch.cuda.synchronize()
    log(f"  graph build: {time.perf_counter() - t0:.2f} s "
        f"({g.num_nodes} nodes, {g.num_edges} edges)")
    gb, tud = tud_batch(gnn, g.device)

    kernel_phases = {"2": lambda: kernel_phase(gnn, g, card),
                     "2h": lambda: bf16_phase(g, gb, card),
                     "2b": lambda: attention_phase(g, card),
                     "2c": lambda: gatv2_phase(g, card),
                     "2d": lambda: dot_phase(g, card),
                     "2e": lambda: sddmm_phase(g, card),
                     "2f": lambda: segment_phase(g, gb, card)}
    kern, only_train = {}, {}

    def merge_kernels(extra):
        """Add the cases of 2g, 2i or 2j to phase 2's, kernel by kernel."""
        for key, val in extra.items():
            k = kern.setdefault(key, {"err": 0.0, "variants": []})
            k["err"] = max(k["err"], val["err"])
            k["variants"] += val["variants"]

    ht_phases = {"3p": lambda: hetero_phase(gnn, g.device, card),
                 "3q": lambda: temporal_phase(gnn, g.device, card)}
    only = args.only.split(",") if args.only else None
    sage_which = [p for p in ("3m", "3n", "2l", "3w")
                  if only is None or p in only]
    link_which = [p for p in ("2j", "3r") if only is None or p in only]
    par_which = [p for p in ("2k", "3t", "3u") if only is None or p in only]
    for phase in (only if only else kernel_phases):
        train_only = {"3b": learned_weights_phase, "3d": gat_a_phase,
                      "3e": gat_b_phase, "3f": gatv2_train_phase,
                      "3l": propagation_phase, "3v": edge_layers_phase,
                      "3o": functools.partial(
                          precision_phase, gb=gb,
                          cells=args.cells and args.cells.split(","),
                          repeat=args.repeat),
                      "3x": reversed_phase}
        if phase == "2l":   # the reversed main graph; a 3n draw with 3n's
            merge_kernels(view_phase_main(g, card))
        if phase in sage_which or phase in link_which or phase in par_which:
            continue
        if phase in ht_phases:
            only_train[phase], extra = ht_phases[phase]()
            merge_kernels(extra)
        elif phase == "3s":
            only_train[phase] = graph_example_phase(gnn, g.device)
        elif phase in train_only:
            only_train[phase] = train_only[phase](*node_inputs(g),
                                                  args.profile)[0]
        else:
            kern.update(kernel_phases[phase]())
    if args.sweep and not set(args.sweep.split(",")) <= {
            *SWEEPS, *SWEEP_PARTS}:
        raise ValueError(f"--sweep takes names of {SWEEPS}, got "
                         f"{args.sweep}")
    sweep = (tuning_sweep(gnn, g, gb, tuple(args.sweep.split(",")))
             if args.sweep else None)

    def run_sage():
        """2g, 3m, 3n, 2l's cases on a 3n draw, 3w; 2g's and 2l's cases
        join phase 2's."""
        res, sage_kern = sage_phases(
            gnn, g.device, card, sage_which, args.profile,
            bool(args.sweep) and "k1" in args.sweep.split(","))
        merge_kernels(sage_kern)
        return res

    def run_link():
        """2j and 3r; 2j's cases join phase 2's."""
        res, link_kern = link_example_phases(gnn, g, card, link_which,
                                             args.profile)
        merge_kernels(link_kern)
        return res

    def run_par():
        """2k, 3t and 3u; 2k's cases join phase 2's."""
        res, par_kern = multi_device_phases(gnn, card, par_which, args.out)
        merge_kernels(par_kern)
        return res

    if args.only:
        if par_which:
            only_train["multi_device"] = run_par()
        if link_which:
            only_train["link_example"] = run_link()
        if sage_which:
            only_train["sage"] = run_sage()
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, "
            f"{args.only} only: no result)")
        log_phase_seconds()
        if args.out:
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump({"card": card_line, "torch": torch.__version__,
                           "cuda": torch.version.cuda, "build_s": build_s,
                           "kernels": kern, "sweep": sweep,
                           "train": only_train,
                           "device_records": DEVICE_RECORDS}, f, indent=1)
        return 0
    main_res = main_path_phase(g, args.profile, args.out)
    graph_res = graph_path_phase(g, gb, args.profile, args.out)
    main_res["vs_cpu"].update(graph_res.pop("vs_cpu"))
    main_res.update(graph_res)
    zoo_res, _ = propagation_phase(*node_inputs(g), args.profile)
    main_res["vs_cpu"].update(zoo_res.pop("vs_cpu"))
    main_res["propagation"] = zoo_res
    edge_res, _ = edge_layers_phase(*node_inputs(g), args.profile)
    main_res["vs_cpu"].update(edge_res.pop("vs_cpu"))
    main_res["edge_layers"] = edge_res
    merge_kernels(view_phase_main(g, card))
    main_res["reversed"], _ = reversed_phase(*node_inputs(g), args.profile)
    main_res["vs_cpu"].update(main_res["reversed"].pop("vs_cpu"))
    bf16_res, _ = precision_phase(*node_inputs(g), args.profile, gb=gb)
    main_res["vs_cpu"].update(bf16_res.pop("vs_cpu"))
    main_res.update(bf16_res)
    main_res["hetero"], extra = ht_phases["3p"]()
    merge_kernels(extra)
    main_res["vs_cpu"]["hetero"] = main_res["hetero"].pop("vs_cpu")
    main_res["temporal"], extra = ht_phases["3q"]()
    merge_kernels(extra)
    main_res["vs_cpu"].update(
        {f"temporal_{k}": v
         for k, v in main_res["temporal"].pop("vs_cpu").items()})
    main_res["tud_batch"] = tud
    sage = run_sage()
    for key in ("sage_host", "sage_device"):
        main_res["vs_cpu"][key] = sage[key].pop("vs_cpu")
    main_res["vs_cpu"].update(sage["sampled_attention"].pop("vs_cpu"))
    main_res["sage"] = sage
    cora = cora_phase(g.device)
    main_res["link_example"] = run_link()
    main_res["vs_cpu"]["link_example"] = main_res["link_example"].pop(
        "vs_cpu")
    main_res["graph_example"] = graph_example_phase(gnn, g.device)
    main_res["vs_cpu"]["graph_example"] = main_res["graph_example"].pop(
        "vs_cpu")
    main_res["multi_device"] = run_par()

    def entry(key, name, src, line, path, pallas=None):
        head = kern[key]["variants"][0]
        return {"name": name, "route": "cuda",
                "source": f"graphneuralnetworks_tpu_torch/csrc/{src}.cu",
                "replaces": "graphneuralnetworks_tpu/ops/pallas/"
                            f"{pallas or src}.py:{line}",
                "launches": main_res[path]["launches"][key],
                "max_abs_err": kern[key]["err"],
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "case": head["case"],
                "device_ms": head["device_ms"], "host_us": head["host_us"],
                "library_device_ms": head["library_device_ms"],
                **{k: head[k] for k in ("f32_device_ms", "library_error")
                   if k in head}}

    # each kernel's launches are read from the path that drives it
    kernels = [
        entry("k1", "spmm_csr_f32", "spmm", 256, "gcn"),
        entry("k2", "spmm_sddmm_csr_f32", "spmm", 331,
              "gcn_learned_edge_weight"),
        entry("k1_bf16", "spmm_csr_bf16", "spmm", 256, "gcn_bf16"),
        entry("k2_bf16", "spmm_sddmm_csr_bf16", "spmm", 331,
              "gcn_learned_bf16"),
        entry("k3", "gat_softmax_f32", "edge_softmax", 804, "gat"),
        entry("k3_bf16", "gat_softmax_bf16", "edge_softmax", 804,
              "gat_bf16"),
        entry("k4", "gat_bwd_dpi_f32", "edge_softmax", 987, "gat"),
        entry("k4_bf16", "gat_bwd_dpi_bf16", "edge_softmax", 987,
              "gat_bf16"),
        entry("k5", "gat_bwd_rev_f32", "edge_softmax", 1045, "gat"),
        entry("k5_bf16", "gat_bwd_rev_bf16", "edge_softmax", 1045,
              "gat_bf16"),
        entry("k12", "edge_softmax_f32", "edge_softmax", 281, "gat_dropout"),
        entry("k12_bf16", "edge_softmax_bf16", "edge_softmax", 281,
              "gat_dropout_bf16"),
        entry("k9", "gatv2_softmax_f32", "edge_softmax", 1237, "gatv2"),
        entry("k10", "gatv2_bwd_dq_f32 + gatv2_da_reduce_f32",
              "edge_softmax", 1398, "gatv2"),
        entry("k11", "gatv2_bwd_rev_f32", "edge_softmax", 1464, "gatv2"),
        entry("k9_bf16", "gatv2_softmax_bf16", "edge_softmax", 1237,
              "gatv2_bf16"),
        entry("k10_bf16", "gatv2_bwd_dq_bf16 + gatv2_da_reduce_f32",
              "edge_softmax", 1398, "gatv2_bf16"),
        entry("k11_bf16", "gatv2_bwd_rev_bf16", "edge_softmax", 1464,
              "gatv2_bf16"),
        entry("k6", "dot_softmax_f32", "edge_softmax", 295, "transformer"),
        entry("k7", "dot_bwd_dq_f32", "edge_softmax", 546, "transformer"),
        entry("k8", "dot_bwd_rev_f32", "edge_softmax", 599, "transformer"),
        entry("k6_bf16", "dot_softmax_bf16", "edge_softmax", 295,
              "transformer_bf16"),
        entry("k7_bf16", "dot_bwd_dq_bf16", "edge_softmax", 546,
              "transformer_bf16"),
        entry("k8_bf16", "dot_bwd_rev_bf16", "edge_softmax", 599,
              "transformer_bf16"),
        entry("k13", "sddmm_csr_f32", "sddmm", 36, "link"),
        entry("k13_bf16", "sddmm_csr_bf16", "sddmm", 36, "link_bf16"),
        entry("k14", "segment_max_csr_f32", "segment", 51, "edgeconv",
              "edge_softmax"),
        entry("k14_bwd", "segment_max_bwd_csr_f32", "segment", 51,
              "edgeconv", "edge_softmax"),
        entry("k14_bf16", "segment_max_csr_bf16", "segment", 51,
              "edgeconv_bf16", "edge_softmax"),
        entry("k14_bwd_bf16", "segment_max_bwd_csr_bf16", "segment", 51,
              "edgeconv_bf16", "edge_softmax"),
    ]
    total_s = time.perf_counter() - t_start
    log(f"total {total_s:.1f} s")
    phase_s = log_phase_seconds()
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card_line, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "kernels": kern, "sweep": sweep,
                       "device_records": DEVICE_RECORDS,
                       "main_path": main_res, "cora": cora,
                       "total_s": total_s, "phase_s": phase_s}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
