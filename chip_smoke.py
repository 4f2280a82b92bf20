#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tgp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with one CUDA card; it builds
the CUDA kernels from ``tgp_tpu_torch/csrc`` into ``build/`` first.  Phases,
each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels (one ``nvcc`` per source, all at once), with each
   kernel's registers, stack frame and spill stores and loads;
3. every kernel against its plain PyTorch version at its path's shapes,
   with times: the kernel, the plain version, the least time the card
   could take (bytes over 3.35 TB/s or flops over the peak of the
   kernel's arithmetic — 67 TFLOP/s f32 for the SpMMs and the SDDMM,
   989 TFLOP/s bf16 tensor cores for the batched product — the larger),
   and one PyTorch library call computing the same function.  K1 and K2
   (and K1's backward, ``d_h`` over the transpose layout) run at the
   serving graph's shapes, each also on the real edges alone
   (``no_pad_ms``) and with its gather rate (``gather_tb_s``); every
   mode of ``segment_spmm.cu`` runs twice and must give the same bits; K3's five modes at the dense slice's and the
   default path's two all-f32 products, each with its route (``"tma"``
   or ``"generic"``), its bound fraction, its time with a warm L2, the
   ``"generic"`` route's time and, where an operand is f32, the library
   call with the cast inside it; then K3 on ragged shapes on either
   route; K4 as the sparse readout runs it (``gather_segment_sum``, the
   rows read through their sort order, masked rows skipped), on the
   route the shape rule picks: the served model's pooled f32 rows of the
   first request (one segment of 65,536 rows, ``"long"``,
   ``segment_reduce.cu``), the dense cell's 64 graphs as one sparse batch
   (64 segments of 256 rows, ``"long"``), 512 graphs of 32 rows
   (``"long"``) and 1,024 of 18 (``"wide"``, ``segment_spmm.cu``), each
   beside
   ``torch.segment_reduce``, the ``index_add_`` the readout once ran, the
   call on each route (``long_ms``, ``old_ms`` for ``"wide"``) and the
   unfused sum of the masked rows in sort order (``unfused_ms``,
   required bit-equal); K4, K5 and K6 on the round-3 banded graph of
   ``scripts/exp_r3_banded.py`` (N = 65,536, E = 1,048,576, F = 128,
   |s − r| ≤ 448, window 1152): K4 on its ``"wide"`` route with the
   ``"long"`` route's time beside it, K5's ring kernel
   (``banded_spmm.cu``) with the unwindowed register gather of
   ``segment_spmm.cu`` that its windowed mode ran before (``old_ms``),
   every row run twice and required bit-equal;
4. serving: ``Predictor`` over ``PoolingClassifier`` (GCN → top-k → GCN →
   sum readout → MLP head, hidden 128, bf16) on full-size requests (one
   graph each: 65,536 nodes, 1,000,000 random edges, 128 features), with
   the kernels' launch counts (K1 3 times and the readout's K4 once a
   request, on its ``"long"`` route), the logits held against the same
   model run on the CPU with
   the kernels' plain versions, and a repeated request required to give
   the same logits bit for bit;
5. dense training (``bench.py::bench_jax`` at full width: 64 graphs × 256
   nodes, ER p = 0.03, 128 features): ``DenseTopkClassifier`` (hidden 128,
   bf16, the batched-product kernel) takes 10 Adam steps; the kernel must
   launch 4 times a step, all on its ``"tma"`` route, and step one's loss
   and gradients are held against the same model and batch on the CPU;
6. the documented default path on the same graphs: ``prepare_batch`` +
   ``PoolingClassifier(pre_normalized=True)`` trains with the kernel and
   with ``torch.matmul`` in turns (kernel, matmul, matmul, kernel; 3 steps
   a turn), the kernel's launches reported by route;
7. sparse training (``bench.py::bench_jax_large`` at full width: one
   graph, 65,536 nodes, 1,000,000 random edges, 128 features, collated
   with ``sort_edges=True``): the served model trains 20 Adam steps on
   label 1; the CSR SpMM kernel must launch 5 times a step (3 forward,
   2 backward) and the readout's K4 once (``"long"``), and step one's
   loss and gradients are held against the same model and graph on the
   CPU;
8. SAG served and trained at the serving width: ``[serving_sag]`` is
   ``[serving]`` with ``get_pooler("sag")`` (its GraphConv scorer's
   ``A X`` one more K1 launch a request, asserted alone first), logits
   held to the CPU and a repeated request bit-equal; ``[train_sag]`` is
   ``[train_sparse]`` with the SAG model for 5 steps (K1 7 times a step);
9. ASAP and PAN: 5 Adam steps each (f32) through the example twins'
   models (``examples/classification_torch.py``'s ``PoolingClassifier``
   with ASAP, ``examples/classification_pan_torch.py``'s ``PANNet``) on
   the dense cell's 64 graphs collated sparse by ``GraphLoader`` (below
   ``PALLAS_MIN_EDGES``: the readout's K4 once a step, no K1), step one
   held against the CPU;
10. the clustering poolers served and trained at the serving width:
   ``[serving_graclus]``, ``[serving_kmis]`` and ``[serving_ec]`` are
   ``[serving]`` with that pooler (K1 once a request for the pre-pool
   GCN; K4 on its ``"wide"`` route for the fixed-order sums — EC's
   softmax normalizer, k-MIS's heuristic, the reduce's cluster sums, the
   merge of duplicate edges — and on its ``"long"`` route once for the
   readout over the 65,536 cluster slots; K2 twice, the post-pool GCN's
   sorted branch on the receiver-major merged edges), each with its
   greedy loop's rounds, logits held to the CPU, the cluster ids equal to
   the CPU's (Graclus's own run; k-MIS's and edge contraction's on the
   card's ranks, which the CPU reference takes: their scores pass through
   bf16 features) and a repeated request required to give the same bits;
   ``[train_ec]`` and ``[train_kmis]`` are ``[train_sparse]`` with that
   model for 5 steps (K1 twice, K2 twice and K4 four times a step, step
   one on the card's ranks);
   ``[train_lap]`` trains LaPool 5 steps (f32) through the classification
   twin's model with ``use_kernel=True`` on the dense cell's graphs
   collated sparse: its dense ``[64, 256, 256]`` pooled graph's GCN
   products run in K3, three a step, step one held against the CPU;
11. the dense soft-cluster family on the dense cell's graphs:
   ``[train_mincut]`` trains ``PoolingClassifier`` with MinCut (K = 16,
   f32, CE + its cut and ortho losses) 5 Adam steps on the batch
   ``prepare_batch(..., pooler=<instance>, normalize=False)`` densifies
   (K3 five times a step: both GCN layers' products forward, three
   backward), ``[train_mincut_u]`` the same with ``"mincut_u"`` on the
   graphs collated sparse by ``GraphLoader`` (its pooled ``[64, 16, 16]``
   graph's GCN in K3, three a step), each with step one held against the
   CPU and the losses finite; ``[dense_family]`` runs MinCut, DiffPool,
   DMoN, HOSC, JustBalance and AsymCheegerCut, batched and ``_u``, one
   forward each: every loss within 1e-4 of the CPU's, batched and ``_u``
   within 5e-4 of each other;
   BNPool joins them: ``[train_bnpool]`` and ``[train_bnpool_u]`` are
   ``[train_mincut]`` and ``[train_mincut_u]`` with ``get_pooler("bnpool")``
   (K = 16, CE + quality + kl + K_prior, its Beta draws and negatives from
   the pooler's sample generator, replayed into the CPU reference), and
   ``[dense_family]`` holds BNPool batched against ``_u`` on shared draws;
12. MaxCut at the serving width: ``[serving_maxcut]`` is ``[serving]``
   with ``get_pooler("maxcut")`` (K1 13 times a request: the pre-pool GCN
   and the 12 δ-GCN rounds; K2 twice; K4 once ``"long"`` and 6 times
   ``"wide"``), cluster ids equal to the CPU's on the card's replayed
   top-k selection, every valid node assigned, a repeated request
   bit-equal; ``[train_maxcut]`` is ``[train_sparse]`` with it for 5
   steps (CE + the maxcut loss, K1 26 times a step); ``[maxcut_dense]``
   runs its dense and sparse engines on the ASAP cell's batch, scores
   within 1e-4 of each other and of the CPU's, the same votes;
13. ``reduce/aggr.py`` on the dense cell's 64 graphs collated sparse:
   ``[aggr_zoo]`` runs each of ``get_aggr``'s 29 aliases through
   ``AggrReduce`` as a readout over the 64 graphs and as a sparse reduce
   under Graclus's assignment, a forward and backward each (K4 counted;
   ``mlp`` and ``patch_transformer`` with ``max_len`` 256), a repeat
   required bit-equal, output and gradients held to the CPU;
   ``[train_aggr_<readout>]`` trains the aggregation example twin's
   ``Net`` (GCN → top-k → GCN → ``AggrReduce`` → head, hidden 128, f32)
   5 steps with the readouts ``sum``, ``mean``, ``lstm`` and
   ``set2set`` (K4 7, 7, 6 and 18 times a step; step one on the card's
   replayed top-k selection); ``[serving_aggr_<readout>]`` serves that
   ``Net`` with ``set2set`` and ``lstm`` at the serving width (K1 3
   times a request, K4 6 and 0 times), logits held to the CPU on the
   card's replayed selection, a repeated request bit-equal, the LSTM's
   recurrent steps reported;
14. the precoarsening pipeline (``examples/pre_coarsening_torch.py``'s
   ``PrecoarsenedNet``, hidden 128, f32: GCN → per level (reduce → GCN) →
   sum readout → head; the selection made on the host beforehand):
   ``[serving_precoarsen]`` serves the full-size requests, each through
   ``PreCoarsening("graclus", levels=2)`` (the native matching asserted)
   and ``PooledGraphLoader(batch_size=1)`` on the card, with precoarsen,
   collate and request ms, K1 once a request and K4 counted, the busy
   time of a forward, a repeated request bit-equal and the logits held to
   the CPU; ``[train_precoarsen_<schedule>]`` trains it 5 Adam steps on
   the ASAP cell after the schedules ``graclus``, ``mixed`` (NDP, then
   Graclus), ``sep``, ``nmf`` (k = 8) and ``eigen`` (k = 12, then 4),
   with the host's seconds, step one repeated bit for bit and held to the
   CPU, the step median, busy time and idle share; ``[host_poolers]``
   calls ``get_pooler`` with ``ndp``, ``nmf``, ``sep`` and ``eigen`` on
   the ASAP cell's batch, pooled output and lift held to the CPU; K4's
   ``[kernels]`` rows at three of these paths' shapes;
15. the locality path on the union of the dense graphs (16,384 nodes):
   ``plan_locality_spmm`` (RCM) and ``locality_spmm`` with the banded
   engine (K5) and the default one (K2), ``spmm_sorted`` (K4) and
   ``sddmm_banded`` (K6) on the same plan, each held against the plain
   product of the graph in its own order;
16. GTVConv, the clustering and autoencoder models, the datasets and the
   checkpoints: two K1 ``[kernels]`` rows at GTVConv's CSR route on the
   serving request (F = 32 f32: the forward over the transpose layout,
   the backward's ``d_h`` with ``d_w``'s time beside it);
   ``[cluster_examples]`` runs the clustering (``mincut``, ``mincut_u``),
   TVGNN and node-classification (``topk``) twins at their JAX defaults
   on the card and on the CPU and fails under the JAX smoke tests' bounds
   (NMI 0.5, accuracy 0.6); ``[train_cluster_mincut]`` and
   ``[train_tvgnn]`` train ``ClusteringModel`` (MinCut; GTVConv +
   AsymCheegerCut) 5 steps on a CSBM at Cora's size (generic routes, K4
   7 and 9 a step); ``[train_tvgnn_large]`` (GTVConv's CSR route,
   ``acc_u``: K1 6 and K4 14 a step) and ``[train_node_class_large]``
   (``PoolLiftNodeClassifier`` with top-k: K1 7 a step) on the serving
   graph; each with step one repeated bit for bit and held to the CPU
   (the node classifier on the card's replayed top-k selection), the
   step median, busy time and idle share; ``[checkpoint]`` saves the
   trained TVGNN model, restores it into a fresh one (``s`` bit-equal)
   and holds a ``PrecoarsenCache`` hit to the cold levels; ``[train_tu]``
   trains the classification twin one epoch on the ``PROTEINS_SYN``
   fixture through its ``load_dataset``.

Every training phase first runs step one twice from the same weights,
batch and generator states and fails unless the loss and every gradient
leaf are bit-equal: every float sum of a step (the segment sums and each
gather's gradient) adds in a fixed order on K4.  Every ``[kernels]`` row
carries the card's ``nvidia-smi`` name and power limit (K1 also at F = 32
f32, MaxCut's widest round; K4 also at three shapes of a step's gather
gradients: MaxCut's post-pool and score gathers, ASAP's); the kernels line counts each kernel's
launches summed over every served and trained path (and K2's in the
locality path); the ``launches:`` line gives each path's K1, K2, K3 and
K4.  K3's
``[kernels]`` rows add MinCut's post-pool product ``[64, 16, 16] ·
[64, 16, 128]`` and one batch of 70,000 products, split into two
launches.  The next-to-last line of output is a JSON object ``{"kernels":
[...]}``; the last is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the rest of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the serving path's sizes: the repo's large-graph model (bench.py)
N_NODES, N_EDGES, FEATURES, HIDDEN, CLASSES = 65_536, 1_000_000, 128, 128, 3
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
REPEATS = 20
SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1.98 GHz boost clock
REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:224"  # _grouped_kernel_w
K2_REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:205"  # _grouped_kernel
SOURCE = "tgp_tpu_torch/csrc/segment_spmm.cu"
# the dense training slice: bench.py::bench_jax's workload at full width
DENSE_GRAPHS, DENSE_NODES, DENSE_P = 64, 256, 0.03
DENSE_STEPS, DEFAULT_STEPS = 10, 3
K3_REPLACES = "tgp_tpu/ops/pallas/bmm.py:37"  # _kernel / bmm_pallas
K3_SOURCE = "tgp_tpu_torch/csrc/bmm.cu"
K3_REL_TOL = 1e-5  # of Σₖ|a||b|: same bf16 products, other f32 sum order
# K1's backward, K4, K5, K6: 1e-5 of Σ|terms| (other f32 sum orders), plus
# one bf16 rounding (2⁻⁷ of the value) where the output is bf16
REL_TOL, BF16_ULP = 1e-5, 2.0 ** -7
K4_REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:38"  # sorted_segment_sum_pallas
K4_SOURCE = "tgp_tpu_torch/csrc/segment_reduce.cu"  # the readout's route
K5_REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:387"  # _banded_kernel
K5_SOURCE = "tgp_tpu_torch/csrc/banded_spmm.cu"
K6_REPLACES = "tgp_tpu/ops/pallas/sddmm.py:49"  # _kernel / banded_sddmm_pallas
K6_SOURCE = "tgp_tpu_torch/csrc/sddmm.cu"
# the round-3 banded graph (scripts/exp_r3_banded.py:21,35-45, BW = 448)
BAND_NODES, BAND_EDGES, BAND_BW = 65_536, 1_048_576, 448
# readouts of many small graphs: batches of TU-benchmark-sized graphs
# (graphs, nodes each): ENZYMES' mean of 32.6 nodes, MUTAG's of 17.9
SMALL_BATCHES = ((512, 32), (1024, 18))
# sparse training: bench.py::bench_jax_large (STEPS_LARGE steps, label 1)
SPARSE_STEPS, K1_PER_STEP = 20, 5
# SAG (GraphConv scorer) on the same graph: its A X one more K1 launch
# forward (a request, a step) and one backward (a step)
SAG_STEPS = 5
# the clustering poolers (Graclus, k-MIS, edge contraction) on the same
# graph: only the pre-pool GCN runs K1 (its product forward, its d_h
# backward); their sums add in a fixed order on K4's "wide" route (EC's
# softmax normalizer and k-MIS's heuristic, one each; the cluster sums of
# the reduce; the merge of duplicate edges), the merged pooled graph
# ascends by receiver, so the post-pool GCN takes the sorted branch (K2
# twice forward: its degree and aggregation; their gradients are
# gathers), and the readout's K4 sums the 65,536 cluster slots on its
# "long" route: a repeated request gives the same bits
CLUSTERS = ("graclus", "kmis", "ec")
CLUSTER_STEPS = 5
# MaxCut on the same graph: the pre-pool GCN and its 12 δ-GCN rounds
# (widths 32 … 8, f32) run K1, 13 launches forward and 13 backward; the
# degree of P, the maxcut loss's sums, the reduce's cluster sums and the
# merge add on K4's "wide" route, the post-pool GCN on K2
MAXCUT_MP_WIDTH = 32
K1_PER_REQUEST = {"topk": 3, "sag": 4, "graclus": 1, "kmis": 1, "ec": 1,
                  "maxcut": 13}
K1_PER_TRAIN_STEP = {"topk": K1_PER_STEP, "sag": K1_PER_STEP + 2,
                     "kmis": 2, "ec": 2, "maxcut": 26}
K4_WIDE_PER_FORWARD = {"topk": 0, "sag": 0, "graclus": 2, "kmis": 3,
                       "ec": 3, "maxcut": 6}
K2_PER_FORWARD = {"topk": 0, "sag": 0, "graclus": 2, "kmis": 2, "ec": 2,
                  "maxcut": 2}
# a training step's K4 launches past the readout: the forward's and, since
# every gather's gradient adds in a fixed order, one a gather of a
# repeated index backward (EC's two score gathers, the post-pool GCN's
# message gather, the maxcut loss's gather of the scores)
K4_WIDE_PER_TRAIN_STEP = {"topk": 0, "sag": 0, "kmis": 4, "ec": 6,
                          "maxcut": 8}
# edge contraction's scores are a softmax over each receiver's edges,
# which a shift of every score leaves as it is: the scorer's bias takes a
# zero gradient, held under its weight's gradient scale on both sides
ZERO_GRADS = {"ec": {"pooler.selector.lin.bias":
                     "pooler.selector.lin.weight"}}
# LaPool on the dense cell's graphs: its dense pooled graph's GCN product
# in K3 forward, and both operands' products backward (the pooled
# adjacency depends on the features through S)
K3_PER_LAP_STEP = 3
# ASAP, PAN and LaPool through the example twins' models, on the dense
# graphs collated sparse (below PALLAS_MIN_EDGES: no K1); launches a step
SMALL_STEPS = 5
# (the readout's K4 once; every other sum of a float, forward, and the
# gradient of every gather, backward, adds in a fixed order on K4 too:
# the generic GCN branch's degree, aggregation and message gather,
# ASAP's attention and cluster sums, PAN's MET products and to_dense,
# LaPool's sparse pre-pool GCN)
SMALL_LAUNCHES = {"asap": {"sorted_segment_sum": 15},
                  "pan": {"sorted_segment_sum": 20},
                  "lap": {"bmm": K3_PER_LAP_STEP, "sorted_segment_sum": 8}}
# step one of training, GPU against the CPU's plain versions (bf16):
LOSS_REL_TOL, GRAD_REL_TOL = 2e-2, 5e-2  # loss; each leaf's max |value|
# the dense soft-cluster family on the dense cell's graphs: MinCut trained
# batched and "_u" (K clusters, f32); its dense GCN products in K3 a step:
# batched, the pre- and post-pool products forward and, backward, the
# pre-pool feature gradient and both post-pool gradients (the pooled
# adjacency depends on the features through S); "_u", the post-pool
# layer's three (its sparse pre-pool layer, below PALLAS_MIN_EDGES,
# launches nothing)
DENSE_FAMILY = ("mincut", "diff", "dmon", "hosc", "jb", "acc")
MINCUT_K, MINCUT_STEPS = 16, 5
# BNPool (K = 16, f32, CE + quality + kl + K_prior) the same, its Beta
# draws and "_u"'s negatives from the pooler's sample generator; the "_u"
# modes' sparse pre-pool GCN, losses and gathers add on K4 (MinCut's
# sparse loss gathers S at both ends of every edge: two gradients)
SOFT_LAUNCHES = {"mincut": {"bmm": 5},
                 "mincut_u": {"bmm": 3, "sorted_segment_sum": 12},
                 "bnpool": {"bmm": 5},
                 "bnpool_u": {"bmm": 3, "sorted_segment_sum": 11}}
SOFT_LOSSES = {"mincut": {"cut_loss", "ortho_loss"},
               "bnpool": {"quality", "kl", "K_prior"}}
# [maxcut_dense]: the two engines' scores (and each against the CPU)
# within this of the score scale after 12 rounds; a forward and backward's
# launches on each engine
MAXCUT_ENGINE_TOL = 1e-4
MAXCUT_DENSE_LAUNCHES = {"dense": {"sorted_segment_sum": 8},
                         "sparse": {"spmm_csr": 24, "sorted_segment_sum": 7}}
# [maxcut_dense]: warm forward-and-backward runs timed on each engine
MAXCUT_DENSE_TIMED = 5
# [dense_family]: each loss on the card within this of the CPU's
# (relative), and batched against "_u" within the contract of
# tests/poolers/test_dense_batched_vs_unbatched.py (rtol = atol)
FAMILY_LOSS_REL_TOL, FAMILY_TWIN_TOL = 1e-4, 5e-4
# K3 above the grid's z limit of 65,535 products: split into launches
K3_SPLIT_BATCH = 70_000
# reduce/aggr.py: every alias of get_aggr on the dense cell's 64 graphs
# collated sparse (a readout over the 64 graphs, and a sparse reduce under
# Graclus's assignment); mlp and patch_transformer size their parameters
# from max_len: the cell's graph size, so nothing is truncated
AGGR_MAX_LEN = DENSE_NODES
AGGR_SIZED = ("mlp", "patch_transformer")
# each output against the port's CPU run, within this of its largest
# |value| (the recurrent ones: cuDNN against the CPU's cells), and each
# gradient leaf within GRAD_REL_TOL of its largest |value|
AGGR_TOL, AGGR_RNN_TOL = 1e-4, 1e-3
AGGR_RNN = ("lstm", "gru", "set2set")
# a bias that shifts every logit of a softmax equally (the attentional
# gate's; each attention block's key bias) takes a zero gradient: rounding
# noise on both sides, held under its weight's gradient scale
AGGR_ZERO_GRADS = {"attentional": ("aggr.dense_0.bias",)}


def aggr_zero_grad(alias, name):
    """Whether ``name``'s gradient is 0 in exact arithmetic."""
    return name in AGGR_ZERO_GRADS.get(alias, ()) or name.endswith(
        ".key.bias")
AGGR_TIMED = 3  # forward-and-backward runs timed per alias and use
# [train_aggr]: the aggregation example twin's Net (GCN → top-k → GCN →
# AggrReduce → head) at hidden 128 with the reference example's readouts;
# K4 a step: the generic GCNs' degree and aggregation forward, their
# message gathers' gradients backward, and the readout's sums (set2set:
# its softmax normalizer and weighted sum, 3 steps, forward and its
# gathers' gradients)
TRAIN_AGGRS = ("sum", "mean", "lstm", "set2set")
SMALL_LAUNCHES.update({f"aggr_{a}": {"sorted_segment_sum": n} for a, n in
                       (("sum", 7), ("mean", 7), ("lstm", 6),
                        ("set2set", 18))})
# [serving_aggr]: the same Net served at the serving width (f32): K1 3
# times a request (the pre-pool GCN, the masked post-pool GCN's degree and
# product); K4: set2set's normalizer and weighted sum, 3 steps; lstm none
SERVING_AGGRS = ("set2set", "lstm")
K4_PER_AGGR_REQUEST = {"set2set": 6, "lstm": 0}
# the precoarsened model (examples/pre_coarsening_torch.py's
# PrecoarsenedNet, hidden 128, f32): GCN → per level (reduce → GCN) → sum
# readout → head, the selection made once on the host beforehand.  Served
# on the serving requests after PreCoarsening("graclus", levels=2): K1 once
# a request (the first GCN's CSR branch), K4 for the rest (a level's
# cluster sums, its generic GCN's degree and aggregation; the readout)
PRE_SERVING_LEVELS = 2
K4_PER_PRE_REQUEST = 1 + 3 * PRE_SERVING_LEVELS
# trained on the ASAP cell with the reference example's schedules and two
# more aliases (NMF with k = 8; EigenPool k = 12 → 4, its modes widening a
# level's input to 3 · 128)
PRE_SCHEDULES = {"graclus": dict(poolers="graclus", levels=2),
                 "mixed": dict(poolers=[("ndp", {}), ("graclus", {})]),
                 "sep": dict(poolers="sep", levels=2),
                 "nmf": dict(poolers=("nmf", {"k": 8}), levels=2),
                 "eigen": dict(poolers=[("eigen", {"k": 12}),
                                        ("eigen", {"k": 4})])}
PRE_STEPS = 5
# K4 a step: 9 forward with a total assignment (the three GCNs' degree and
# aggregation, each level's cluster sums, the readout; NDP's partial
# selection and the dense levels reduce without it) and 3 backward (the
# GCNs' message gathers)
PRE_K4_PER_STEP = {"graclus": 12, "mixed": 11, "sep": 12, "nmf": 10,
                   "eigen": 10}
# the host-side poolers through get_pooler on the ASAP cell's batch; the
# pooled features and the lift held to the CPU call within this of their
# largest |value| (other sum orders of f32 products)
HOST_POOLERS = {"ndp": {}, "nmf": {"k": 8}, "sep": {}, "eigen": {"k": 8}}
HOST_POOL_TOL = 1e-4
# the clustering, TVGNN and node-classification slice: the twins at their
# JAX defaults against the JAX smoke tests' bounds (NMI, test accuracy)
NMI_BOUND, ACC_BOUND = 0.5, 0.6
# a CSBM at Cora's size (2,708 nodes, 7 classes, 1,433 features), degree
# (~3.9) and homophily (~0.8): ~10.6k directed edges
CORA = dict(num_graphs=1, num_nodes=2708, num_communities=7,
            feature_dim=1433, p_in=0.0082, p_out=0.00032,
            require_connected=False, seed=0)
CORA_K = 7
# ClusteringModel / PoolLiftNodeClassifier width, Adam steps a phase, the
# serving graph's clusters (acc_u) and node classes
CLUSTER_HIDDEN, CLUSTER_TRAIN_STEPS, CLUSTER_SEED = 32, 5, 0
LARGE_K, NODE_CLASSES = 4, 4
# launches a step.  On the Cora-sized graph (below PALLAS_MIN_EDGES) only
# K4: the generic GCN's degree and aggregation forward and its message
# gather's gradient a layer, and to_dense (MinCut: 2·2 + 2 + 1); GTVConv's
# generic route, its degree and Γh forward and its two gathers' gradients
# a layer, and to_dense (TVGNN: 2·2 + 2·2 + 1).  On the serving graph
# GTVConv's CSR route runs K1 twice forward (the degree and Γh) and once
# backward (d_h) a layer, K4 its two γ gathers' gradients a layer, and
# acc_u's sums K4 ten times (its connect's SpMM, the total variation, the
# quantile and the balance, and their gathers' gradients); the node
# classifier's three GCNs run K1 forward and backward, the masked pooled
# graph's one more for its degree, and top-k's masked pool and lift no sum
CLUSTER_PHASES = ("cluster_mincut", "tvgnn", "tvgnn_large",
                  "node_class_large")
CLUSTER_LAUNCHES = {"cluster_mincut": {"sorted_segment_sum": 7},
                    "tvgnn": {"sorted_segment_sum": 9},
                    "tvgnn_large": {"spmm_csr": 6, "sorted_segment_sum": 14},
                    "node_class_large": {"spmm_csr": 7}}


def request_graph(seed: int):
    """One request as ``bench.py``'s large-graph leg makes it."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N_NODES, N_EDGES)
    r = rng.integers(0, N_NODES, N_EDGES)
    x = rng.normal(size=(N_NODES, FEATURES)).astype(np.float32)
    return x, np.stack([s, r])


def dense_graphs(seed: int = 0):
    """``bench.py::make_graphs``: 64 ER graphs of 256 nodes, 128 features,
    labels in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(DENSE_GRAPHS):
        n = DENSE_NODES
        upper = np.triu(rng.random((n, n)) < DENSE_P, k=1)
        s, r = np.nonzero(upper | upper.T)
        x = rng.normal(size=(n, FEATURES)).astype(np.float32)
        graphs.append((x, np.stack([s, r]).astype(np.int64)))
    labels = rng.integers(0, 3, size=DENSE_GRAPHS).astype(np.int32)
    return graphs, labels


def banded_graph():
    """``scripts/exp_r3_banded.py``'s graph: receiver-sorted, |s − r| ≤
    448, normal weights; ``(s, r, w, row_ptr, x)`` as numpy."""
    rng = np.random.default_rng(0)
    r = np.sort(rng.integers(0, BAND_NODES, BAND_EDGES)).astype(np.int32)
    s = np.clip(r + rng.integers(-BAND_BW, BAND_BW + 1, BAND_EDGES), 0,
                BAND_NODES - 1).astype(np.int32)
    w = rng.normal(size=BAND_EDGES).astype(np.float32)
    counts = np.bincount(r, minlength=BAND_NODES)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    x = rng.normal(size=(BAND_NODES, FEATURES)).astype(np.float32)
    return s, r, w, row_ptr, x


def _wrappers():
    """Every kernel wrapper of the port, by route name (each counts its
    launches in ``.launches``)."""
    from tgp_tpu_torch.ops.kernels import bmm, sddmm, segment_spmm

    return {"spmm_csr": segment_spmm.spmm_csr,
            "segment_sum_sorted": segment_spmm.segment_sum_sorted,
            "bmm": bmm.bmm,
            "sorted_segment_sum": segment_spmm.sorted_segment_sum,
            "spmm_banded": segment_spmm.banded_sorted_spmm,
            "sddmm_banded": sddmm.banded_sddmm}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        routes = getattr(fn, "launches_by_route", {})
        routes.update(dict.fromkeys(routes, 0))


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _demangle(names):
    """C++ names of mangled symbols, by ``c++filt`` where it exists."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        return got if out.returncode == 0 and len(got) == len(names) else names
    except OSError:
        return names


def ptxas_kernels(log: str) -> list:
    """Each entry function of an ``nvcc -Xptxas -v`` log with its
    registers, stack frame and spill stores and loads (bytes)."""
    props, regs, order, cur = {}, {}, [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            order.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            props[cur] = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            regs[cur] = int(m.group(1))
    names = _demangle(order)
    return [dict(kernel=re.sub(r"^void |\(.*", "", pretty.replace(
                     "(anonymous namespace)::", "")),
                 registers=regs.get(k), stack_frame=props.get(k, (0,) * 3)[0],
                 spill_stores=props.get(k, (0,) * 3)[1],
                 spill_loads=props.get(k, (0,) * 3)[2])
            for k, pretty in zip(order, names)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: the card's ``nvidia-smi`` name and power limit, set by main() and
#: written into every [kernels] row
CARD = None


def median_ms(fn, flush: torch.Tensor | None) -> float:
    """Median device time of ``fn`` over REPEATS launches, each after an
    L2 flush (the serving path finds the edge arrays cold; none when
    ``flush`` is None) and a spin kernel of SPIN_CYCLES, which keeps the
    card busy while the host enqueues the events and ``fn``: the events
    then time the device's work, not the host's enqueue (tens of µs a
    wrapper call)."""
    fn()
    times = []
    for _ in range(REPEATS):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn) -> float:
    """Host time of one call of ``fn`` (checks, allocation, launch), mean
    over REPEATS calls enqueued without waiting for the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / REPEATS


def _worst(name, got, ref, scale, rel_tol, slack=0.0):
    """Largest |got − ref| and (|got − ref| − slack·|ref|) / scale; raises
    past ``rel_tol`` or on a non-finite value."""
    err = ((got.float() - ref.float()).abs()
           - slack * ref.float().abs()).clamp(min=0)
    max_abs = float((got.float() - ref.float()).abs().max())
    worst = float((err / (scale + 1e-30)).max())
    if not (torch.isfinite(got.float()).all() and worst <= rel_tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |err| {max_abs}, max err/scale "
                             f"{worst} > {rel_tol}")
    return max_abs, worst


def check_mode(name, kernel, plain, library, *, rel_tol, bound_bytes, flops,
               peak, scale, flush, note=None, slack=0.0, extra=None,
               gather_bytes=None, twice=False):
    """Hold one kernel mode against its plain version, then time all
    three.  Tolerance: |kernel − plain| ≤ rel_tol · scale (per element: Σ|w·x| of the row, Σₖ|a||b| of
    the product) + slack · |plain| (one rounding of the output).  ``peak``:
    flop/s of the kernel's arithmetic on this card; ``extra``: fields
    added to the row; ``gather_bytes``: the bytes the kernel gathers
    (E·F·itemsize), reported with their rate ``gather_tb_s``; ``twice``:
    run the kernel again on the same inputs and fail unless the two
    results are equal bit for bit."""
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    max_abs, worst = _worst(name, got, ref, scale, rel_tol, slack)
    if twice:
        again = kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(
                f"{name}: two runs on the same inputs differ (max |diff| "
                f"{float((got.float() - again.float()).abs().max())})")
    bound_ms = 1e3 * max(bound_bytes / HBM_BYTES_PER_S, flops / peak)
    ms = median_ms(kernel, flush)
    row = dict(mode=name, card=CARD, max_abs_err=max_abs,
               max_rel_err=worst,
               rel_tol=rel_tol, ms=ms, plain_ms=median_ms(plain, flush),
               bound_ms=bound_ms, bound_fraction=bound_ms / ms,
               bound_by=("bytes" if bound_bytes / HBM_BYTES_PER_S
                         >= flops / peak else "operations"),
               bound_bytes=bound_bytes, flops=flops, peak_flops=peak,
               library_ms=median_ms(library, flush),
               kernel_host_us=host_us(kernel))
    if twice:
        row["bit_equal_runs"] = True
    if gather_bytes is not None:
        row.update(gather_bytes=gather_bytes,
                   gather_tb_s=gather_bytes / (ms * 1e-3) / 1e12)
    row.update(extra or {})
    if note:
        row["library"] = note
    print(f"[kernels] {json.dumps(row)}", flush=True)
    return row


def phase_kernels(batch):
    """Each kernel mode the serving path runs (and the K2 mode) at its
    shapes, on the collated request's own CSR arrays, each run twice and
    required bit-equal; ``no_pad_ms`` times the same call on the real
    edges only (the collator's padding edges, all in row 0, dropped and
    the offsets rebuilt)."""
    from tgp_tpu_torch.ops.kernels import segment_spmm as K

    N = batch.num_nodes
    E = batch.num_edges
    rows = batch.row_ptr.shape[0] - 1
    idx, row_ptr = batch.senders, batch.row_ptr
    w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    csr_bytes = 4 * (2 * E + rows + 1)  # idx, w, row_ptr
    modes = {}
    # the real edges alone, in both layouts
    real = batch.edge_mask
    idx_r, w_r = idx[real].contiguous(), w[real].contiguous()
    rp_r = K.build_row_ptr(batch.receivers[real], rows)
    real_t = real[torch.argsort(batch.senders.long(), stable=True)]

    def sparse_mm(values, cols, dense):
        a = torch.sparse_csr_tensor(row_ptr, cols, values.to(dense.dtype),
                                    size=(rows, dense.shape[0]),
                                    check_invariants=False)
        return lambda: torch.sparse.mm(a, dense)

    for dtype, F, weights, x in (
            (torch.bfloat16, FEATURES, w, None),
            (torch.float32, FEATURES, w, None),
            # MaxCut's widest δ-GCN round (f32, 32 wide)
            (torch.float32, MAXCUT_MP_WIDTH, w, None),
            # the degree pass of the post-pool GCN: x = node mask, |w|
            (torch.float32, 1, w.abs(),
             batch.node_mask.to(torch.float32)[:, None].contiguous())):
        if x is None:
            x = torch.randn(N, F, generator=gen, device="cuda").to(dtype)
        scale = K.spmm_csr_plain(x.float().abs(), weights.abs(), idx,
                                 row_ptr, N)
        isz = x.element_size()
        w_real = weights[real].contiguous()
        name = f"K1 spmm_csr F={F} {str(dtype).split('.')[-1]}"
        modes[name] = check_mode(
            name, lambda: K.spmm_csr(x, weights, None, idx, None, row_ptr,
                                     None, None, None, N),
            lambda: K.spmm_csr_plain(x, weights, idx, row_ptr, N),
            sparse_mm(weights, idx, x),
            rel_tol=REL_TOL, slack=BF16_ULP if dtype == torch.bfloat16
            else 0.0, bound_bytes=csr_bytes + 2 * N * F * isz,
            flops=2 * E * F, peak=FP32_FLOPS_PER_S, scale=scale, flush=flush,
            gather_bytes=E * F * isz, twice=True,
            extra={"no_pad_ms": median_ms(
                lambda: K.spmm_csr(x, w_real, None, idx_r, None, rp_r, None,
                                   None, None, N), flush)})

    # K1's backward: d_h = Aᵀg over the sender-sorted transpose layout, as
    # the gradient runs it (the kernel rounds w_t to the bf16 cotangent's
    # dtype and clamps the receivers)
    g = torch.randn(N, FEATURES, generator=gen, device="cuda").to(
        torch.bfloat16)
    w_t = batch.edge_weight_t.to(torch.float32)
    idx_t = batch.receivers_t.clamp(0, N - 1)
    rp_t = batch.row_ptr_t
    w_tb = w_t.to(torch.bfloat16).float()
    scale = K.spmm_csr_plain(g.float().abs(), w_t.abs(), idx_t, rp_t, N)
    a_t = torch.sparse_csr_tensor(rp_t, idx_t, w_tb.to(torch.bfloat16),
                                  size=(rows, N), check_invariants=False)
    idx_tr, w_tr = idx_t[real_t].contiguous(), w_t[real_t].contiguous()
    rp_tr = K.build_row_ptr(batch.senders_t[real_t], rows)
    name = "K1 spmm_csr backward d_h F=128 bfloat16"
    modes[name] = check_mode(
        name, lambda: K.spmm_csr(g, w_t, None, idx_t, None, rp_t, None,
                                 None, None, N),
        lambda: K.spmm_csr_plain(g, w_t, idx_t, rp_t, N),
        lambda: torch.sparse.mm(a_t, g), rel_tol=REL_TOL, slack=BF16_ULP,
        bound_bytes=csr_bytes + 2 * N * FEATURES * 2,
        flops=2 * E * FEATURES, peak=FP32_FLOPS_PER_S, scale=scale,
        flush=flush, gather_bytes=E * FEATURES * 2, twice=True,
        extra={"no_pad_ms": median_ms(
            lambda: K.spmm_csr(g, w_tr, None, idx_tr, None, rp_tr, None,
                               None, None, N), flush)})

    # K2 mode: receiver-sorted messages [E, F], no gather, no weight
    msgs = (torch.randn(E, FEATURES, generator=gen, device="cuda")
            * w[:, None]).to(torch.bfloat16)
    rec = batch.receivers
    msgs_r, rec_r = msgs[real].contiguous(), rec[real].contiguous()
    scale = K.segment_sum_sorted_plain(msgs.float().abs(), rec, N, row_ptr)
    ones = torch.ones(E, device="cuda")
    cols = torch.arange(E, dtype=torch.int32, device="cuda")
    name = "K2 segment_sum_sorted F=128 bfloat16"
    modes[name] = check_mode(
        name, lambda: K.segment_sum_sorted(msgs, rec, N, row_ptr),
        lambda: K.segment_sum_sorted_plain(msgs, rec, N, row_ptr),
        sparse_mm(ones, cols, msgs), rel_tol=REL_TOL, slack=BF16_ULP,
        bound_bytes=4 * (rows + 1) + 2 * E * FEATURES + 2 * N * FEATURES,
        flops=E * FEATURES, peak=FP32_FLOPS_PER_S, scale=scale, flush=flush,
        gather_bytes=E * FEATURES * 2, twice=True,
        extra={"no_pad_ms": median_ms(
            lambda: K.segment_sum_sorted(msgs_r, rec_r, N, rp_r), flush)})
    del flush
    return modes


def phase_kernels_banded():
    """K4, K5 and K6 on the round-3 banded graph: K4 sums its gathered
    bf16 messages (its ``"wide"`` route; ``long_ms`` the ``"long"``
    route's time), K5 gathers bf16 x through its 1152-row windows (the
    ring kernel; ``old_ms`` the register gather of ``segment_spmm.cu``
    that its windowed mode ran, here on the same layout without the
    window, which cuts no edge of this graph), K6 dots f32 rows of two
    matrices (every 512-edge chunk's ids fit its window, so every edge is
    computed)."""
    from tgp_tpu_torch.ops.kernels import sddmm as SD
    from tgp_tpu_torch.ops.kernels import segment_spmm as K
    from tgp_tpu_torch.ops.ordering import choose_banded_window

    s, r, w, rp, x = (torch.tensor(a, device="cuda")
                      for a in banded_graph())
    N, E, F = BAND_NODES, BAND_EDGES, FEATURES
    window = choose_banded_window(BAND_BW)
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    xb = x.to(bf16)
    modes = {}

    def csr(cols, values, n_cols):
        return torch.sparse_csr_tensor(rp, cols, values, size=(N, n_cols),
                                       check_invariants=False)

    msgs = (xb[s.long()].float() * w[:, None]).to(bf16)
    a_k4 = csr(torch.arange(E, dtype=torch.int32, device="cuda"),
               torch.ones(E, dtype=bf16, device="cuda"), E)
    name = "K4 sorted_segment_sum F=128 bfloat16"
    route = K.segment_route(N, E, F)
    long_scale = K.sorted_segment_sum_plain(msgs.float().abs(), r, rp, N)
    long_out = K._k4_sum(msgs, None, None, rp, N, "long")
    torch.cuda.synchronize()
    _worst(f"{name} long route", long_out,
           K.sorted_segment_sum_plain(msgs, r, rp, N), long_scale, REL_TOL,
           BF16_ULP)
    modes[name] = check_mode(
        name, lambda: K.sorted_segment_sum(msgs, r, rp, N),
        lambda: K.sorted_segment_sum_plain(msgs, r, rp, N),
        lambda: torch.sparse.mm(a_k4, msgs), rel_tol=REL_TOL,
        slack=BF16_ULP, bound_bytes=4 * (N + 1) + 2 * E * F + 2 * N * F,
        flops=E * F, peak=FP32_FLOPS_PER_S, scale=long_scale,
        flush=flush, gather_bytes=2 * E * F, twice=True,
        extra={"route": route, "long_ms": median_ms(
            lambda: K._k4_sum(msgs, None, None, rp, N, "long"),
            flush)})

    a_k5 = csr(s, w.to(bf16), N)
    name = f"K5 banded_sorted_spmm F=128 bfloat16 window={window}"
    modes[name] = check_mode(
        name, lambda: K.banded_sorted_spmm(xb, s, rp, w, N, window=window),
        lambda: K.banded_sorted_spmm_plain(xb, s, rp, w, N, window=window),
        lambda: torch.sparse.mm(a_k5, xb), rel_tol=REL_TOL, slack=BF16_ULP,
        bound_bytes=4 * (2 * E + N + 1) + 2 * 2 * N * F, flops=2 * E * F,
        peak=FP32_FLOPS_PER_S,
        scale=K.banded_sorted_spmm_plain(xb.float().abs(), s, rp, w.abs(),
                                         N, window=window),
        flush=flush, gather_bytes=2 * E * F, twice=True,
        extra={"route": K.banded_route(xb), "old_ms": median_ms(
            lambda: K.spmm_csr(xb, w, None, s, None, rp, None, None, None,
                               N), flush)})

    b = torch.randn(N, F, generator=gen, device="cuda")
    # the library's SDDMM: (b @ xᵀ) sampled at (r, s), one value per edge;
    # its pattern lists each row's columns in ascending order
    order = torch.argsort(r.long() * N + s.long())
    pattern = csr(s[order], torch.zeros(E, device="cuda"), N)
    x_t = x.t().contiguous()
    name = f"K6 banded_sddmm F=128 float32 window={window}"
    modes[name] = check_mode(
        name, lambda: SD.banded_sddmm(x, b, s, r, window=window),
        lambda: SD.banded_sddmm_plain(x, b, s, r, window=window),
        lambda: torch.sparse.sampled_addmm(pattern, b, x_t, beta=0.0),
        rel_tol=REL_TOL, bound_bytes=4 * 3 * E + 4 * 2 * N * F,
        flops=2 * E * F, peak=FP32_FLOPS_PER_S,
        scale=SD.banded_sddmm_plain(x.abs(), b.abs(), s, r, window=window),
        flush=flush, note="torch.sparse.sampled_addmm (cuSPARSE SDDMM)",
        gather_bytes=4 * 2 * E * F, twice=True)
    del flush
    return modes


def phase_kernels_readout(batch, d_graphs):
    """K4 as the sparse readout runs it: ``gather_segment_sum`` on the
    route ``segment_route`` picks, reading f32 rows of 128 through the
    stable sort of their graph ids and skipping masked rows, on four
    batches: the served model's post-pool rows of the first request (one
    segment of 65,536 rows, half masked), the dense cell's 64 graphs
    collated as one sparse batch (64 segments of 256 rows) and the
    ``SMALL_BATCHES`` (seeded rows, a tenth masked; 1,024 graphs of 18
    rows take the ``"wide"`` route, the others ``"long"``).  The bound counts each kept row read
    once, the order, the mask, the offsets and the output.  Beside each
    row: ``torch.segment_reduce`` on the masked rows in sort order, the
    ``index_add_`` the readout once ran (``index_add_ms``), the same call
    forced onto each route (``long_ms``; ``old_ms``, the ``"wide"`` route
    the readout ran before ``segment_reduce.cu``; both held to the plain
    version first), and the unfused sum (``unfused_ms``:
    ``sorted_segment_sum`` of the masked rows copied in sort order), which
    must give the gathered call's bits."""
    from torch.nn import functional as F_

    from tgp_tpu_torch import from_graphs
    from tgp_tpu_torch.ops.kernels import segment_spmm as K

    model = build_model("cuda").eval()
    with torch.inference_mode():
        x = batch.x
        for conv in model.pre_convs:
            x = F_.relu(conv(batch, x))
        g = model.pooler(batch.with_features(x)).graph
        h = g.x
        for conv in model.post_convs:
            h = F_.relu(conv(g, h))
    d_batch = from_graphs(d_graphs, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    batches = [
        (h.float().contiguous(), g.node_graph, g.node_mask, g.num_graphs),
        (d_batch.x.float().contiguous(), d_batch.node_graph,
         d_batch.node_mask, d_batch.num_graphs)]
    for graphs, nodes in SMALL_BATCHES:
        n = graphs * nodes
        batches.append((
            torch.randn(n, HIDDEN, generator=gen, device="cuda"),
            torch.arange(n, device="cuda") // nodes,
            torch.rand(n, generator=gen, device="cuda") >= 0.1, graphs))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for rows_f, ids, mask, B in batches:
        N, F = rows_f.shape
        ids = ids.long()
        cids = ids.to(torch.int32)
        rids, perm = torch.sort(cids, stable=True)
        perm = perm.to(torch.int32)
        rp = torch.searchsorted(rids, torch.arange(
            B + 1, dtype=torch.int32, device="cuda"), out_int32=True)
        masked = torch.where(mask[:, None], rows_f, 0.0)
        in_order = masked[perm.long()].contiguous()
        route = K.segment_route(B, N, F)

        def kernel():
            return K.gather_segment_sum(rows_f, perm, mask, cids, rp, B)

        def on_route(r):
            return lambda: K._k4_sum(rows_f, perm, mask, rp, B, r)

        def unfused():
            return K.sorted_segment_sum(in_order, rids, rp, B)

        def plain():
            return K.gather_segment_sum_plain(rows_f, perm, mask, rp, B)

        scale = K.gather_segment_sum_plain(rows_f.abs(), perm, mask, rp, B)
        ref = plain()
        for r in K.SEGMENT_ROUTES:
            _worst(f"K4 readout segments={B} {r} route", on_route(r)(), ref,
                   scale, REL_TOL)
        if not torch.equal(kernel(), unfused()):
            raise AssertionError(f"K4 readout segments={B}: the gathered "
                                 "call differs from the unfused sum of the "
                                 "masked rows")
        kept = int(mask.sum())
        name = f"K4 readout F={F} float32 segments={B}"
        rows[name] = check_mode(
            name, kernel, plain,
            lambda: torch.segment_reduce(in_order, "sum",
                                         offsets=rp.long()),
            rel_tol=REL_TOL,
            bound_bytes=4 * kept * F + 4 * N + N + 4 * (B + 1) + 4 * B * F,
            flops=kept * F, peak=FP32_FLOPS_PER_S, scale=scale, flush=flush,
            note="torch.segment_reduce(sum, offsets) of the masked rows in "
                 "sort order", twice=True,
            extra={"rows": N, "kept_rows": kept, "route": route,
                   "long_ms": median_ms(on_route("long"), flush),
                   "old_ms": median_ms(on_route("wide"), flush),
                   "unfused_ms": median_ms(unfused, flush),
                   "index_add_ms": median_ms(
                       lambda: torch.zeros(B, F, device="cuda").index_add_(
                           0, ids, masked), flush)})
    del flush
    return rows


def phase_kernels_gather_grad(batch, d_graphs, d_labels):
    """K4 as a training step's gather gradients run it (``gather_rows``'
    backward: the cotangent rows summed into their ids' segments, read
    through a stable sort of the ids), at three shapes of the main path:
    MaxCut's post-pool GCN (the cotangent of its message gather, 128 bf16
    wide, over the senders of the served pooled graph of the first
    request, into its nodes), MaxCut's score gathers (1 f32 wide, over
    the request's senders, into its 65,536 nodes; the δ-GCN degree and
    the loss's sums take the same shape) and the ASAP cell's gathers (128
    f32 wide, over its edges and self-loops, into its 16,384 nodes).  Each
    is held to the plain version at REL_TOL and run twice for the same
    bits.  The bound counts each cotangent row read once, the order, the
    keep flags, the offsets and the output.  Library: the ``index_add_``
    the gradient once was; beside it ``torch.segment_reduce`` on the rows
    in sort order (``segment_reduce_ms``) and the stable sort with its
    offsets that precede the kernel (``sort_ms``)."""
    from torch.nn import functional as F_

    from tgp_tpu_torch.data import GraphLoader
    from tgp_tpu_torch.mp.gcn import gcn_norm
    from tgp_tpu_torch.ops.kernels import segment_spmm as K
    from tgp_tpu_torch.ops.segment import _sorted_layout

    model = build_model("cuda", alias="maxcut").eval()
    with torch.inference_mode():
        x = batch.x
        for conv in model.pre_convs:
            x = F_.relu(conv(batch, x))
        pooled = model.pooler(batch.with_features(x)).graph
    asap, _ = next(iter(GraphLoader(d_graphs, d_labels,
                                    batch_size=len(d_graphs), device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = (("maxcut post-pool", pooled.senders, pooled.num_nodes, HIDDEN,
              torch.bfloat16),
             ("maxcut scores", batch.senders, batch.num_nodes, 1,
              torch.float32),
             ("asap", gcn_norm(asap)[0], asap.num_nodes, HIDDEN,
              torch.float32))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for what, ids, B, F, dtype in cases:
        ids = ids.long()
        E = ids.shape[0]
        g = torch.randn(E, F, generator=gen, device="cuda").to(dtype)
        cids = ids.to(torch.int32)
        keep = torch.ones(E, dtype=torch.bool, device="cuda")
        perm, rp = _sorted_layout(ids, B, False)
        in_order = g[perm.long()].contiguous()
        isz = g.element_size()
        name = (f"K4 gather gradient {what} F={F} "
                f"{str(dtype).split('.')[-1]} segments={B}")
        rows[name] = check_mode(
            name, lambda: K.gather_segment_sum(g, perm, keep, cids, rp, B),
            lambda: K.gather_segment_sum_plain(g, perm, keep, rp, B),
            lambda: torch.zeros(B, F, dtype=dtype, device="cuda").index_add_(
                0, ids, g),
            rel_tol=REL_TOL, slack=BF16_ULP if dtype == torch.bfloat16
            else 0.0,
            bound_bytes=isz * E * F + 4 * E + E + 4 * (B + 1) + isz * B * F,
            flops=E * F, peak=FP32_FLOPS_PER_S,
            scale=K.gather_segment_sum_plain(g.float().abs(), perm, keep, rp,
                                             B),
            flush=flush, note="index_add_ (the gather's own gradient)",
            twice=True,
            extra={"rows": E, "route": K.segment_route(B, E, F),
                   "sort_ms": median_ms(
                       lambda: _sorted_layout(ids, B, False), flush),
                   "segment_reduce_ms": median_ms(
                       lambda: torch.segment_reduce(
                           in_order, "sum", offsets=rp.long()), flush)})
    del flush
    return rows


def phase_kernels_aggr(batch, d_graphs, d_labels):
    """K4 at the two shapes ``reduce/aggr.py`` adds: the served ``set2set``
    readout's softmax normalizer (the first request's pooled graph as the
    aggregation Net pools it: 65,536 rows of 1 f32 into one segment, its
    unselected half skipped, 3 times a request) and the sparse reduce's
    sums under Graclus's assignment of the dense cell's batch (16,384 rows
    of 128 f32 into its 16,384 cluster slots).  Each held to the plain
    version at REL_TOL and run twice for the same bits; library: the
    ``index_add_`` a scatter-add sum would be; ``sort_ms``: the stable
    sort and offsets before the kernel."""
    import torch.nn.functional as F_

    from examples.classification_aggr_reduce_torch import Net
    from tgp_tpu_torch import get_pooler
    from tgp_tpu_torch.data import GraphLoader
    from tgp_tpu_torch.ops.kernels import segment_spmm as K
    from tgp_tpu_torch.ops.segment import _sorted_layout

    net = Net(FEATURES, "set2set", num_classes=CLASSES, hidden=HIDDEN,
              device="cuda", generator=torch.Generator().manual_seed(0))
    small, _ = next(iter(GraphLoader(d_graphs, d_labels,
                                     batch_size=len(d_graphs), device="cuda")))
    with torch.inference_mode():
        pooled = net.pooler(batch.with_features(
            F_.relu(net.conv(batch)))).graph
        so = get_pooler("graclus", device="cuda")(small).so
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = (("set2set normalizer", pooled.node_graph, pooled.node_mask,
              pooled.num_graphs, 1),
             ("graclus reduce", so.cluster_index, so.node_sel_mask,
              so.num_clusters, FEATURES))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for what, ids, keep, B, F in cases:
        ids = ids.long()
        E = ids.shape[0]
        x = torch.randn(E, F, generator=gen, device="cuda")
        cids = ids.to(torch.int32)
        perm, rp = _sorted_layout(ids, B, False)
        name = f"K4 aggr {what} F={F} float32 segments={B}"
        rows[name] = check_mode(
            name, lambda: K.gather_segment_sum(x, perm, keep, cids, rp, B),
            lambda: K.gather_segment_sum_plain(x, perm, keep, rp, B),
            lambda: torch.zeros(B, F, device="cuda").index_add_(
                0, ids, torch.where(keep[:, None], x, 0.0)),
            rel_tol=REL_TOL,
            bound_bytes=4 * E * F + 4 * E + E + 4 * (B + 1) + 4 * B * F,
            flops=E * F, peak=FP32_FLOPS_PER_S,
            scale=K.gather_segment_sum_plain(x.abs(), perm, keep, rp, B),
            flush=flush, note="index_add_ of the masked rows", twice=True,
            extra={"rows": E, "kept": int(keep.sum()),
                   "route": K.segment_route(B, E, F),
                   "sort_ms": median_ms(
                       lambda: _sorted_layout(ids, B, False), flush)})
    del flush
    return rows


def phase_kernels_k3(adj):
    """K3 at the dense training slice's shapes, on its normalized bf16
    adjacency ``adj [64, 256, 256]`` (its top-left 128 × 128 blocks for
    the post-pool shape): the two forward products, the two backward
    ``db = aᵀ g`` with an f32 cotangent ``g``, and the ``trans_b`` mode
    (``da = g bᵀ``, which the top-k step does not run); MinCut's
    post-pool product on its pooled ``[64, 16, 16]`` graph in all three
    modes its step runs (forward, ``db = aᵀ g``, and ``da = g bᵀ``, since
    the pooled adjacency carries a gradient back to ``S``); then the
    default path's products, with the adjacency and the features in f32.
    Each row names
    its route and adds the kernel's time with a warm L2
    (``warm_l2_ms``), the ``"generic"`` route's time on a copy of ``a``
    one element off 16-byte alignment (``generic_ms``, held against the
    plain version first) and, where an operand is f32, ``torch.bmm`` with
    the cast to bf16 inside the timed call (``library_with_cast_ms``).
    Then ragged shapes on either route (``[k3_ragged]``)."""
    from tgp_tpu_torch.ops.kernels import bmm as K

    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    B, N = adj.shape[:2]
    K2 = N // 2
    post = adj[:, :K2, :K2].contiguous()

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, a, b, trans_a, trans_b
        ("fwd pre", adj, rnd(B, N, HIDDEN, dtype=bf16), False, False),
        # MinCut's pooled graph [64, 16, 16] (f32, as the f32 model runs it)
        ("fwd mincut post", torch.rand(B, MINCUT_K, MINCUT_K, generator=gen,
                                       device="cuda"),
         rnd(B, MINCUT_K, HIDDEN, dtype=f32), False, False),
        ("bwd mincut post trans_a", torch.rand(B, MINCUT_K, MINCUT_K,
                                               generator=gen, device="cuda"),
         rnd(B, MINCUT_K, HIDDEN, dtype=f32), True, False),
        ("bwd mincut post trans_b", rnd(B, MINCUT_K, HIDDEN, dtype=f32),
         rnd(B, MINCUT_K, HIDDEN, dtype=f32), False, True),
        # one batch above the grid's limit: two launches
        ("fwd split batch", torch.rand(K3_SPLIT_BATCH, MINCUT_K, MINCUT_K,
                                       generator=gen, device="cuda"),
         rnd(K3_SPLIT_BATCH, MINCUT_K, HIDDEN, dtype=f32), False, False),
        ("fwd post", post, rnd(B, K2, HIDDEN, dtype=bf16), False, False),
        ("bwd pre trans_a", adj, rnd(B, N, HIDDEN, dtype=f32), True, False),
        ("bwd post trans_a", post, rnd(B, K2, HIDDEN, dtype=f32), True,
         False),
        ("trans_b", rnd(B, N, HIDDEN, dtype=f32),
         rnd(B, N, HIDDEN, dtype=bf16), False, True),
        ("f32 fwd pre", adj.float(), rnd(B, N, HIDDEN, dtype=f32), False,
         False),
        ("f32 bwd pre trans_a", adj.float(), rnd(B, N, HIDDEN, dtype=f32),
         True, False),
    ]
    # torch.bmm with an f32 output from bf16 operands, where this torch
    # has it (aten::bmm.dtype); else bf16 output
    out_f32 = hasattr(torch.ops.aten.bmm, "dtype")
    note = ("torch.bmm(bf16, bf16, out_dtype=float32)" if out_f32
            else "torch.bmm(bf16, bf16) -> bf16")
    kw = {"out_dtype": f32} if out_f32 else {}
    modes = {}
    for name, a, b, ta, tb in cases:
        B = a.shape[0]
        a_view = a.transpose(1, 2) if ta else a
        b_view = b.transpose(1, 2) if tb else b
        a_op, b_op = a_view.to(bf16), b_view.to(bf16)
        n, m = a_op.shape[1:]
        f = b_op.shape[2]
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + 4 * B * n * f)
        full = f"K3 bmm {name} [{B},{n},{m}]x[{B},{m},{f}]"
        scale = K.bmm_plain(a.abs(), b.abs(), ta, tb)
        skewed = torch.empty(a.numel() + 1, dtype=a.dtype,
                             device="cuda")[1:].view(a.shape).copy_(a)
        if K.route(skewed, b, ta, tb) != "generic":
            raise AssertionError(f"{full}: a skewed copy kept the tma route")
        got = K.bmm(skewed, b, ta, tb)
        torch.cuda.synchronize()
        _worst(f"{full} generic route", got, K.bmm_plain(a, b, ta, tb), scale,
               K3_REL_TOL)
        before = K.bmm.launches
        K.bmm(a, b, ta, tb)
        extra = {"route": K.route(a, b, ta, tb),
                 "launches_per_call": K.bmm.launches - before,
                 "warm_l2_ms": median_ms(lambda: K.bmm(a, b, ta, tb), None),
                 "generic_ms": median_ms(lambda: K.bmm(skewed, b, ta, tb),
                                         flush)}
        if f32 in (a.dtype, b.dtype):
            extra["library_with_cast_ms"] = median_ms(
                lambda: torch.bmm(a_view.to(bf16), b_view.to(bf16), **kw),
                flush)
        modes[name] = check_mode(
            full, lambda: K.bmm(a, b, ta, tb),
            lambda: K.bmm_plain(a, b, ta, tb),
            lambda: torch.bmm(a_op, b_op, **kw), rel_tol=K3_REL_TOL,
            bound_bytes=nbytes, flops=2 * B * n * m * f,
            peak=BF16_TC_FLOPS_PER_S, scale=scale, flush=flush, note=note,
            extra=extra)
    if modes["fwd split batch"]["launches_per_call"] != 2:
        raise AssertionError(f"K3 at {K3_SPLIT_BATCH} products launched "
                             f"{modes['fwd split batch']['launches_per_call']}"
                             " times, want 2")
    del flush
    phase_k3_ragged()
    return modes


def phase_k3_ragged():
    """K3 on ragged shapes in every transpose mode, held against
    ``bmm_plain``: an aligned one on the ``"tma"`` route (TMA's zero fill
    and clipped stores at every edge, two column tiles) in bf16 and f32,
    and an unaligned one on the ``"generic"`` route; each call's route is
    read from the route counters."""
    from tgp_tpu_torch.ops.kernels import bmm as K

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for (batch, n, m, f), want in (((3, 200, 136, 120), "tma"),
                                   ((2, 40, 72, 200), "tma"),
                                   ((5, 70, 130, 33), "generic")):
        for dtype in (torch.bfloat16, torch.float32):
            for ta, tb in ((False, False), (True, False), (False, True)):
                a = torch.randn((batch, m, n) if ta else (batch, n, m),
                                generator=gen, device="cuda").to(dtype)
                b = torch.randn((batch, f, m) if tb else (batch, m, f),
                                generator=gen, device="cuda").to(dtype)
                before = dict(K.bmm.launches_by_route)
                got = K.bmm(a, b, ta, tb)
                torch.cuda.synchronize()
                took = [r for r, c in K.bmm.launches_by_route.items()
                        if c != before[r]]
                name = (f"K3 bmm [{batch},{n},{m},{f}] "
                        f"{str(dtype).split('.')[-1]} ta={ta} tb={tb}")
                if took != [want]:
                    raise AssertionError(f"{name} took {took}, want {want}")
                _, worst = _worst(name, got, K.bmm_plain(a, b, ta, tb),
                                  K.bmm_plain(a.abs(), b.abs(), ta, tb),
                                  K3_REL_TOL)
                rows.append(dict(case=name, route=want, max_rel_err=worst))
    print(f"[k3_ragged] {json.dumps(rows)}", flush=True)
    return rows


@contextlib.contextmanager
def pinned_ranks(record=None, replay=None):
    """Record the ranks the k-MIS and edge-contraction selections draw
    (appended to ``record``, on the CPU), or hand out ``replay``'s in
    their place, in order: the CPU reference then runs the greedy loop in
    the card's order.  Their scores pass through bf16 features, so an
    independent CPU run may break near-ties the other way."""
    from tgp_tpu_torch.select import edge_contraction, kmis

    real = edge_contraction.rank_by
    queue = list(replay or [])

    def rank_by(score, valid):
        if replay is not None:
            return queue.pop(0).to(score.device)
        out = real(score, valid)
        record.append(out.cpu())
        return out

    for mod in (edge_contraction, kmis):
        mod.rank_by = rank_by
    try:
        yield
    finally:
        for mod in (edge_contraction, kmis):
            mod.rank_by = real
    if replay is not None and queue:
        raise AssertionError(f"{len(queue)} recorded ranks left unused")


@contextlib.contextmanager
def pinned_selection(record=None, replay=None, topk=False):
    """Record MaxCut's top-k selections (which nodes are kept, appended to
    ``record`` on the CPU), or hand out ``replay``'s in their place, in
    order, their weights the scores of this run: the CPU reference then
    votes from the card's selection.  The scores are tanh'd through bf16
    features, so an independent CPU top-k may break exact ties the other
    way.  ``topk``: the top-k pooler's selections too (the aggregation
    Net's: an f32 score near a tie may rank the other way on the CPU)."""
    from tgp_tpu_torch.select import maxcut, topk as topk_mod

    mods = (maxcut, topk_mod) if topk else (maxcut,)
    reals = {m: m.topk_select_from_scores for m in mods}
    queue = list(replay or [])

    def pinned(real):
        def select(score, batch, *args, **kw):
            so = real(score, batch, *args, **kw)
            if replay is None:
                record.append((so.cluster_index.cpu(),
                               so.node_sel_mask.cpu()))
                return so
            ci, keep = (t.to(score.device) for t in queue.pop(0))
            return so.replace(cluster_index=ci, node_sel_mask=keep,
                              weight=torch.where(keep, score, 0.0))
        return select

    for m, real in reals.items():
        m.topk_select_from_scores = pinned(real)
    try:
        yield
    finally:
        for m, real in reals.items():
            m.topk_select_from_scores = real
    if replay is not None and queue:
        raise AssertionError(f"{len(queue)} recorded selections left unused")


@contextlib.contextmanager
def pinned_draws(record=None, replay=None):
    """Record BNPool's Gamma draws and sampled negatives (appended to
    ``record`` on the CPU, in order), or hand out ``replay``'s in their
    place: the CPU reference then computes the card's function."""
    from tgp_tpu_torch.poolers import bnpool
    from tgp_tpu_torch.select import dp

    real_gamma, real_neg = dp.draw_gamma, bnpool.negative_edge_sampling
    queue = list(replay or [])

    def moved(out, device):
        return (tuple(t.to(device) for t in out) if isinstance(out, tuple)
                else out.to(device))

    def pinned(real):
        def draw(on, generator, **kw):  # on: the alphas, or the batch
            if replay is not None:
                return moved(queue.pop(0), on.device)
            out = real(on, generator, **kw)
            record.append(moved(out, "cpu"))
            return out
        return draw

    dp.draw_gamma = pinned(real_gamma)
    bnpool.negative_edge_sampling = pinned(real_neg)
    try:
        yield
    finally:
        dp.draw_gamma, bnpool.negative_edge_sampling = real_gamma, real_neg
    if replay is not None and queue:
        raise AssertionError(f"{len(queue)} recorded draws left unused")


def step_one_repeats(tag, loss_and_grads, generators=()):
    """Step one twice from the same weights, batch and generator states
    (restored before each run and after): the loss and every gradient leaf
    must be bit-equal (every sum of the step adds in a fixed order).
    ``loss_and_grads()`` returns ``(loss, {name: grad})`` (or ``(loss,
    out, {name: grad})``) without an update."""
    states = [g.get_state() for g in generators]
    runs = []
    for _ in range(2):
        for g, st in zip(generators, states):
            g.set_state(st)
        got = loss_and_grads()
        runs.append((got[0].detach().clone(), got[-1]))
    for g, st in zip(generators, states):
        g.set_state(st)
    (l1, g1), (l2, g2) = runs
    diff = sorted(k for k in g1 if not torch.equal(g1[k], g2[k]))
    if not torch.equal(l1, l2) or diff or set(g1) != set(g2):
        worst = {k: float((g1[k] - g2[k]).abs().max()) for k in diff}
        raise AssertionError(f"{tag}: step one repeated from the same "
                             f"weights differs: loss {float(l1)} vs "
                             f"{float(l2)}, leaves {worst}")
    return True


def build_model(device, *, alias="topk", pool_mode="auto", use_kernel=None,
                seed=0):
    """The served model with the ``alias`` pooler (top-k, SAG with its
    GraphConv scorer, or a clustering pooler), its weights drawn from one
    seeded generator; ``use_kernel`` also reaches SAG's scorer."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    g = torch.Generator().manual_seed(seed)
    pooler = get_pooler(alias, in_channels=HIDDEN, ratio=0.5,
                        pool_mode=pool_mode, use_kernel=use_kernel,
                        device=device, generator=g)
    return PoolingClassifier(pooler, num_classes=CLASSES, hidden=HIDDEN,
                             compute_dtype=torch.bfloat16,
                             use_kernel=use_kernel, device=device,
                             generator=g)


def phase_serving(card, graphs, batch, collate_ms, profile: bool,
                  alias="topk"):
    """Serve ``graphs`` (``batch`` is the first, collated) with the
    defaults a user gets, count the kernel launches, and hold the logits
    to the CPU.  ``alias="sag"`` serves SAG: its GraphConv scorer must run
    its ``A X`` in K1 (one more launch a request).  A clustering pooler
    (``CLUSTERS``): K1 once, K4 ``K4_WIDE_PER_FORWARD`` times more on its
    ``"wide"`` route and K2 twice a request, the greedy loop's rounds
    reported; Graclus's clusters equal the CPU's own run, k-MIS's and edge
    contraction's the CPU's run on the card's ranks (the CPU reference
    takes them).  A repeated request must give the same bits (every sum
    of each path has a fixed order)."""
    from tgp_tpu_torch import Predictor

    tag = "serving" if alias == "topk" else f"serving_{alias}"
    k1_per_request = K1_PER_REQUEST[alias]
    clustering = alias in CLUSTERS
    total = clustering or alias == "maxcut"  # a total assignment
    model = build_model("cuda", alias=alias).eval()
    predictor = Predictor(lambda b: model(b)[0], batch_size=1,
                          sort_edges=True, device="cuda")
    ranks, sels = [], []
    with torch.inference_mode(), pinned_ranks(record=ranks), \
            pinned_selection(record=sels):
        logits, out = model(batch)  # warm-up: cuBLAS handles, allocator
    if not total and out.so.extras.get("pool_mode") != "masked":
        raise AssertionError("the served request did not take masked pooling")
    if alias == "sag":
        # the scorer alone: its A X is one K1 launch, at the input width
        reset_counts()
        with torch.inference_mode():
            model.pooler.score(batch.with_features(
                torch.randn(batch.num_nodes, HIDDEN, device="cuda")))
        scorer = read_counts()
        if scorer["spmm_csr"] != 1 or sum(scorer.values()) != 1:
            raise AssertionError(f"SAG's scorer launched {scorer}, want one "
                                 "K1 launch (its CSR branch)")

    # the main path, counted: the predictor answers every request
    reset_counts()
    req_ms, served = [], []
    for g in graphs:
        t0 = time.perf_counter()
        served.append(predictor([g]))
        req_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    k4_routes = dict(_wrappers()["sorted_segment_sum"].launches_by_route)
    wide = K4_WIDE_PER_FORWARD[alias] * REQUESTS
    want = dict.fromkeys(launches, 0)
    want.update(spmm_csr=k1_per_request * REQUESTS,
                sorted_segment_sum=REQUESTS + wide,
                segment_sum_sorted=K2_PER_FORWARD[alias] * REQUESTS)
    if launches != want or k4_routes != dict(long=REQUESTS, wide=wide):
        raise AssertionError(f"{REQUESTS} requests launched {launches}, K4 "
                             f"by route {k4_routes}, want {want}, every "
                             f"readout on the long route and {wide} wide")
    served = np.concatenate(served)
    if served.shape != (REQUESTS, CLASSES) or not np.isfinite(served).all():
        raise AssertionError(f"bad logits {served}")
    # every sum of the path has a fixed order, so the same request gives
    # the same bits
    again = predictor([graphs[0]])
    repeat_equal = bool(np.array_equal(again[0], served[0]))
    if not repeat_equal:
        raise AssertionError(f"two requests on one graph differ: {again[0]} "
                             f"vs {served[0]} (max |diff| "
                             f"{float(np.abs(again[0] - served[0]).max())})")

    fwd = []
    with torch.inference_mode():
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(batch)
            end.record()
            end.synchronize()
            fwd.append(start.elapsed_time(end))

    # the same model and request on the CPU, kernels' plain versions (the
    # clustering poolers' greedy loops in the card's order)
    cpu_model = build_model("cpu", alias=alias, pool_mode="masked",
                            use_kernel=True)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.inference_mode(), pinned_ranks(replay=ranks), \
            pinned_selection(replay=sels):
        ref, ref_out = cpu_model(batch.to("cpu"))
    ref = ref.numpy()
    tol = 2e-2 * float(np.abs(ref).max())
    diff = float(np.abs(served[0] - ref[0]).max())
    if (not total and ref_out.so.extras.get("pool_mode") != "masked"
            or diff > tol):
        raise AssertionError(f"GPU logits {served[0]} vs CPU {ref[0]}: "
                             f"max |diff| {diff} > {tol}")

    result = dict(
        card=card, requests=REQUESTS, request_ms=req_ms,
        request_ms_median=statistics.median(req_ms),
        edges_per_s=N_EDGES / (statistics.median(req_ms) / 1e3),
        collate_ms=collate_ms, forward_device_ms=statistics.median(fwd),
        forward_device_ms_all=fwd, launches=launches,
        k4_launches_by_route=k4_routes,
        k1_launches_per_request=launches["spmm_csr"] / REQUESTS,
        k4_launches_per_request=launches["sorted_segment_sum"] / REQUESTS,
        k2_launches_per_request=launches["segment_sum_sorted"] / REQUESTS,
        logits_first=served[0].tolist(), cpu_logits_first=ref[0].tolist(),
        max_abs_diff_vs_cpu=diff, tol=tol, repeat_bit_equal=repeat_equal)
    if alias == "sag":
        result["scorer_launches"] = scorer
    if alias == "maxcut":
        # the card's selection replayed: the same votes on the CPU; after
        # the propagation rounds and the fallback every valid node has a
        # cluster
        got_ci = out.so.cluster_index.cpu()
        if not torch.equal(got_ci, ref_out.so.cluster_index):
            raise AssertionError(
                f"maxcut: {int((got_ci != ref_out.so.cluster_index).sum())}"
                " cluster ids differ from the CPU's")
        unassigned = int((batch.node_mask & ~out.so.node_sel_mask).sum())
        if unassigned:
            raise AssertionError(f"maxcut: {unassigned} valid nodes left "
                                 "unassigned")
        result.update(clusters=int(out.so.out_mask().sum()),
                      kept=int(sels[0][1].sum()), unassigned=unassigned,
                      cluster_ids_equal_cpu=True, selection_from="card")
    if clustering:
        # the same clusters: Graclus's ranks come from the input's weights
        # (the CPU ran its own), the others' from the card (replayed)
        got_ci = out.so.cluster_index.cpu()
        if not torch.equal(got_ci, ref_out.so.cluster_index):
            raise AssertionError(
                f"{alias}: {int((got_ci != ref_out.so.cluster_index).sum())}"
                " cluster ids differ from the CPU's")
        rounds = int(out.so.extras["rounds"])
        if rounds != int(ref_out.so.extras["rounds"]):
            raise AssertionError(f"{alias}: {rounds} rounds on the card, "
                                 f"{int(ref_out.so.extras['rounds'])} on "
                                 "the CPU")
        result.update(rounds=rounds, clusters=int(out.so.out_mask().sum()),
                      cluster_ids_equal_cpu=True,
                      ranks_from="input" if alias == "graclus" else "card")
    print(f"[{tag}] {json.dumps(result)}", flush=True)

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with torch.inference_mode(), prof(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                model(batch)
            torch.cuda.synchronize()
        print(f"[{tag} profile]", flush=True)
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=25), flush=True)
        from torch.autograd import DeviceType
        busy = sum(e.self_device_time_total for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
        row = dict(forwards=3, device_busy_ms=busy,
                   busy_ms_per_forward=busy / 3)
        print(f"[{tag} profile] {json.dumps(row)}", flush=True)
    return result


def _timed_step(step):
    """Run ``step()`` between two CUDA events; (device ms, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _train_step(model, opt, batch, y, aux):
    """One step of ``bench.py``'s loop: softmax cross-entropy (+ the
    pooler's auxiliary losses on the default path), backward, Adam."""
    opt.zero_grad(set_to_none=True)
    logits, out = model(batch)
    loss = torch.nn.functional.cross_entropy(logits, y)
    if aux:
        loss = loss + out.loss_sum()
    loss.backward()
    opt.step()
    return loss.detach()


def _step_one_grads(model, batch, y, aux=False):
    """Loss and gradients (copies, on the model's device) of one step,
    without the update (``aux``: the pooler's auxiliary losses added)."""
    model.zero_grad(set_to_none=True)
    logits, out = model(batch)
    loss = torch.nn.functional.cross_entropy(logits, y)
    if aux:
        loss = loss + out.loss_sum()
    loss.backward()
    return loss.detach(), {k: v.grad.detach().float().clone()
                           for k, v in model.named_parameters()}


def _step_one_errors(name, loss, grads, cpu_loss, cpu_grads, zero=None):
    """Step one on the card against the CPU: the loss's relative error
    and each gradient leaf's largest error over its largest |value|;
    raises past LOSS_REL_TOL or GRAD_REL_TOL.  ``zero`` maps a leaf whose
    gradient is 0 in exact arithmetic (rounding noise on both sides, so
    not compared with each other) to the leaf whose largest |value| it is
    held under, on the card and on the CPU, within GRAD_REL_TOL."""
    zero = zero or {}
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_err = {k: float((grads[k] - g).abs().max()
                         / max(float(g.abs().max()), 1e-30))
                for k, g in cpu_grads.items() if k not in zero}
    for k, ref in zero.items():
        scale = max(float(cpu_grads[ref].abs().max()), 1e-30)
        grad_err[k] = max(float(grads[k].abs().max()),
                          float(cpu_grads[k].abs().max())) / scale
    if loss_err > LOSS_REL_TOL or max(grad_err.values()) > GRAD_REL_TOL:
        raise AssertionError(f"{name} on the card vs the CPU: loss {loss} "
                             f"vs {cpu_loss}, gradient errors {grad_err}")
    return loss_err, grad_err


def phase_train_dense(card, dense, y, n_edges, profile: bool):
    """10 Adam steps of ``DenseTopkClassifier`` on the card (bf16, K3),
    K3 counted, step one held against the CPU."""
    from tgp_tpu_torch import DenseTopkClassifier
    from tgp_tpu_torch.ops.kernels import bmm as K

    def build(device):
        return DenseTopkClassifier(
            num_classes=CLASSES, hidden=HIDDEN, ratio=0.5,
            pre_normalized=True, compute_dtype=torch.bfloat16,
            use_kernel=True, in_channels=FEATURES, device=device,
            generator=torch.Generator().manual_seed(0))

    model = build("cuda")
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    repeat = step_one_repeats("train_dense",
                              lambda: _step_one_grads(model, dense, y))
    # the main path, counted: 10 steps, K3 four times a step, all "tma"
    reset_counts()
    step_ms, losses, per_step, per_step_tma = [], [], [], []
    for i in range(DENSE_STEPS):
        before = K.bmm.launches
        before_tma = K.bmm.launches_by_route["tma"]
        if i == 0:  # step one keeps its gradients for the CPU check
            def first():
                out = _step_one_grads(model, dense, y)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            loss0 = float(loss)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
        else:
            ms, loss = _timed_step(
                lambda: _train_step(model, opt, dense, y, aux=False))
        step_ms.append(ms)
        losses.append(float(loss))
        per_step.append(K.bmm.launches - before)
        per_step_tma.append(K.bmm.launches_by_route["tma"] - before_tma)
    launches = read_counts()
    by_route = dict(K.bmm.launches_by_route)
    if per_step != [4] * DENSE_STEPS or per_step_tma != per_step:
        raise AssertionError(f"K3 launches per step {per_step}, on the tma "
                             f"route {per_step_tma}, want 4 and 4")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")

    # step one on the CPU: same weights and batch, plain versions
    cpu = build("cpu")
    cpu.load_state_dict(init)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = _step_one_grads(cpu, dense.to("cpu"), y.cpu())
    cpu_loss = float(cpu_loss)
    cpu_s = time.perf_counter() - t0
    loss_err, grad_err = _step_one_errors("step one", loss0, grads0,
                                          cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    result = dict(
        card=card, graphs=DENSE_GRAPHS, nodes=DENSE_NODES, edges=n_edges,
        steps=DENSE_STEPS, step_ms=step_ms, step_ms_median=med,
        edges_per_s=n_edges / (med / 1e3), losses=losses,
        launches=launches, launches_per_step=per_step,
        bmm_launches_by_route=by_route, step1_loss=loss0,
        step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, cpu_check_s=cpu_s,
        step1_repeat_bit_equal=repeat,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[train_dense] {json.dumps(result)}", flush=True)

    if profile:
        # the profiler slows the host: the idle share is taken against the
        # unprofiled median step
        _idle_profile(lambda: _train_step(model, opt, dense, y, aux=False),
                      3, med, "train_dense")
    return result


def phase_train_default(card, graphs, labels):
    """``bench.py::bench_jax_default`` on the card: ``prepare_batch``
    densifies, ``PoolingClassifier(pre_normalized=True)`` trains with the
    kernel (K3 counted) and with ``torch.matmul``, in turns (kernel,
    matmul, matmul, kernel), each turn DEFAULT_STEPS steps from the same
    weights."""
    from tgp_tpu_torch import (DenseGraphBatch, PoolingClassifier,
                               from_graphs, get_pooler, prepare_batch)
    from tgp_tpu_torch.ops.kernels import bmm as K

    g = torch.Generator().manual_seed(1)
    pooler = get_pooler("topk", in_channels=HIDDEN, ratio=0.5,
                        device="cuda", generator=g)
    batch = prepare_batch(from_graphs(graphs, device="cuda"), pooler=pooler,
                          normalize=True)
    if not isinstance(batch, DenseGraphBatch):
        raise AssertionError("prepare_batch did not densify the batch")
    y = torch.tensor(labels, device="cuda").long()
    model = PoolingClassifier(pooler, num_classes=CLASSES, hidden=HIDDEN,
                              in_channels=FEATURES, pre_normalized=True,
                              use_kernel=True, device="cuda", generator=g)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    result = {"card": card, "steps_per_turn": DEFAULT_STEPS,
              "kernel": {"step_ms": [], "launches": [],
                         "launches_by_route": []},
              "matmul": {"step_ms": [], "launches": [],
                         "launches_by_route": []}}
    for conv in (*model.pre_convs, *model.post_convs):
        conv.use_kernel = True
    result["step1_repeat_bit_equal"] = step_one_repeats(
        "train_default", lambda: _step_one_grads(model, batch, y, aux=True))
    for route in ("kernel", "matmul", "matmul", "kernel"):
        model.load_state_dict(init)
        for conv in (*model.pre_convs, *model.post_convs):
            conv.use_kernel = route == "kernel"
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        reset_counts()
        runs = [_timed_step(lambda: _train_step(model, opt, batch, y,
                                                aux=True))
                for _ in range(DEFAULT_STEPS)]
        losses = [float(loss) for _, loss in runs]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{route}: non-finite losses {losses}")
        launches = read_counts()
        want = dict.fromkeys(launches, 0)
        want["bmm"] = 4 * DEFAULT_STEPS if route == "kernel" else 0
        if launches != want:
            raise AssertionError(f"{route} route launched {launches}, "
                                 f"want {want}")
        row = result[route]
        row["step_ms"] += [ms for ms, _ in runs]
        row["launches"].append(launches["bmm"])
        row["launches_by_route"].append(dict(K.bmm.launches_by_route))
        row["losses"] = losses
    for route in ("kernel", "matmul"):
        result[route]["step_ms_median"] = statistics.median(
            result[route]["step_ms"])
    print(f"[train_default] {json.dumps(result)}", flush=True)
    return result


def _idle_profile(step, steps, med_ms, tag, table=True):
    """Profile ``steps`` calls of ``step()`` and print the kernel table
    (with ``table``) and the device's busy time a step; the idle share of
    an unprofiled step is 1 − (busy per step) / (its median time
    ``med_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = p.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    if table:
        print(events.table(sort_by="self_device_time_total", row_limit=30),
              flush=True)
    # index_add_'s kernels (indexFuncSmallIndex / indexFuncLargeIndex)
    index_add_ms = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA
                       and "indexfunc" in e.key.lower()) / 1e3
    row = dict(steps=steps, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
               index_add_device_ms=index_add_ms,
               busy_ms_per_step=busy_ms / steps,
               idle_share=1 - busy_ms / steps / med_ms)
    print(f"[{tag} profile] {json.dumps(row)}", flush=True)
    return row


def phase_train_sparse(card, profile: bool, alias="topk"):
    """``bench.py::bench_jax_large`` on the card: the served model trains
    SPARSE_STEPS Adam steps on one full-size graph (bf16, the CSR kernel
    forward and backward, masked pooling), K1 counted every step, step one
    held against the CPU.  ``alias="sag"``: the SAG model, SAG_STEPS
    steps, two more K1 launches a step (its scorer's A X and gradient).
    ``"ec"``/``"kmis"``: CLUSTER_STEPS steps, K1 twice a step (the
    pre-pool GCN), K4 ``K4_WIDE_PER_FORWARD`` times more on its ``"wide"``
    route and K2 twice (the fixed-order sums of the forward), the CPU's
    step one on the card's step-one ranks."""
    from tgp_tpu_torch import from_graphs

    tag = "train_sparse" if alias == "topk" else f"train_{alias}"
    steps = {"topk": SPARSE_STEPS, "sag": SAG_STEPS}.get(alias,
                                                         CLUSTER_STEPS)
    k1_per_step = K1_PER_TRAIN_STEP[alias]
    clustering = alias in CLUSTERS
    total = clustering or alias == "maxcut"

    x, ei = request_graph(7)  # bench_jax_large's graph: default_rng(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = from_graphs([(x, ei)], sort_edges=True, device="cuda")
    torch.cuda.synchronize()
    collate_ms = 1e3 * (time.perf_counter() - t0)
    n_edges = int(batch.edge_mask.sum())
    y = torch.tensor([1], device="cuda")
    # the sum readout over 32,768 kept nodes puts the logits in the tens or
    # hundreds, so a model whose top logit is already label 1 has a loss of
    # 0 and nothing to compare: take the first seed whose loss is >= 1
    for seed in range(16):
        model = build_model("cuda", alias=alias, seed=seed)
        with torch.no_grad():
            logits, out = model(batch)
        if float(torch.nn.functional.cross_entropy(logits, y)) >= 1.0:
            break
    else:
        raise AssertionError("no seed in 0..15 gives label 1 a loss >= 1")
    if not total and out.so.extras.get("pool_mode") != "masked":
        raise AssertionError("the training graph did not take masked pooling")
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    K1 = _wrappers()["spmm_csr"]
    K4 = _wrappers()["sorted_segment_sum"]
    aux = alias == "maxcut"  # CE + the maxcut loss
    repeat = step_one_repeats(
        tag, lambda: _step_one_grads(model, batch, y, aux=aux))

    # the main path, counted: K1 k1_per_step times a step and K4 (the
    # readout) once, on its "long" route
    reset_counts()
    step_ms, losses, per_step, k4_per_step = [], [], [], []
    ranks, sels = [], []
    for i in range(steps):
        before, k4_before = K1.launches, K4.launches_by_route["long"]
        if i == 0:  # step one keeps its gradients for the CPU check
            def first():
                with pinned_ranks(record=ranks), \
                        pinned_selection(record=sels):
                    out = _step_one_grads(model, batch, y, aux=aux)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            loss0 = float(loss)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
        else:
            ms, loss = _timed_step(
                lambda: _train_step(model, opt, batch, y, aux=aux))
        step_ms.append(ms)
        losses.append(float(loss))
        per_step.append(K1.launches - before)
        k4_per_step.append(K4.launches_by_route["long"] - k4_before)
    launches = read_counts()
    if per_step != [k1_per_step] * steps or k4_per_step != [1] * steps:
        raise AssertionError(f"K1 launches per step {per_step}, K4 on the "
                             f"long route {k4_per_step}, want {k1_per_step} "
                             "and 1")
    want = dict.fromkeys(launches, 0)
    want.update(spmm_csr=k1_per_step * steps,
                sorted_segment_sum=(1 + K4_WIDE_PER_TRAIN_STEP[alias]) * steps,
                segment_sum_sorted=K2_PER_FORWARD[alias] * steps)
    if launches != want:
        raise AssertionError(f"{steps} steps launched {launches}, want "
                             f"{want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")

    # step one on the CPU: same weights and graph, plain versions
    cpu = build_model("cpu", alias=alias, pool_mode="masked",
                      use_kernel=True)
    cpu.load_state_dict(init)
    t0 = time.perf_counter()
    with pinned_ranks(replay=ranks), pinned_selection(replay=sels):
        cpu_loss, cpu_grads = _step_one_grads(cpu, batch.to("cpu"),
                                              y.cpu(), aux=aux)
    cpu_loss = float(cpu_loss)
    cpu_s = time.perf_counter() - t0
    loss_err, grad_err = _step_one_errors("step one", loss0, grads0,
                                          cpu_loss, cpu_grads,
                                          zero=ZERO_GRADS.get(alias))
    med = statistics.median(step_ms)
    extra = {}
    if clustering:  # the greedy loop's rounds in a forward after the steps
        with torch.no_grad():
            _, out = model(batch)
        extra = dict(rounds=int(out.so.extras["rounds"]),
                     clusters=int(out.so.out_mask().sum()))
    result = dict(
        **extra, card=card, nodes=batch.num_nodes, edges=n_edges,
        edge_slots=batch.num_edges, seed=seed, steps=steps,
        step_ms=step_ms,
        step_ms_median=med, edges_per_s=n_edges / (med / 1e3),
        collate_ms=collate_ms, losses=losses, launches=launches,
        k1_launches_per_step=per_step, k4_launches_per_step=k4_per_step,
        step1_loss=loss0,
        step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, cpu_check_s=cpu_s,
        step1_repeat_bit_equal=repeat,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    if profile:
        result["profile"] = _idle_profile(
            lambda: _train_step(model, opt, batch, y, aux=aux), 3, med,
            tag)
    return result


def _small_model(which, device, seed=0):
    """The example twins' models at the dense cell's width: the
    classification example's ``PoolingClassifier`` with ASAP, or with
    LaPool and its dense pooled graph's products in K3, ``PANNet``, or
    the aggregation example's ``Net`` with the readout ``aggr_<alias>``;
    ``logits(model, batch)`` reads each one's logits."""
    if which.startswith("aggr_"):
        from examples.classification_aggr_reduce_torch import Net

        return Net(FEATURES, which[len("aggr_"):], num_classes=CLASSES,
                   hidden=HIDDEN, device=device,
                   generator=torch.Generator().manual_seed(seed))
    if which in ("asap", "lap"):
        from examples.classification_torch import build_model as build

        return build(which, CLASSES, HIDDEN, FEATURES, device=device,
                     use_kernel=True if which == "lap" else None,
                     seed=seed)
    from examples.classification_pan_torch import PANNet

    return PANNet(FEATURES, CLASSES, HIDDEN, device=device,
                  generator=torch.Generator().manual_seed(seed))


def _logits(model, batch):
    out = model(batch)
    return out[0] if isinstance(out, tuple) else out


def phase_train_small(card, graphs, labels, which, profile: bool):
    """ASAP (``which="asap"``), PAN, LaPool (``"lap"``) or the
    aggregation Net (``"aggr_<readout>"``) trains SMALL_STEPS Adam steps
    (f32) through the example twin's model on the dense cell's 64 graphs,
    collated sparse by ``GraphLoader``; below PALLAS_MIN_EDGES no K1 runs;
    the launches a step are ``SMALL_LAUNCHES[which]`` (the readout's K4
    once; LaPool's dense pooled graph K3 three times, by route); step one
    held against the CPU (the aggregation Net's on the card's top-k
    selection, replayed)."""
    from tgp_tpu_torch.data import GraphLoader

    loader = GraphLoader(graphs, labels, batch_size=len(graphs),
                         device="cuda")
    batch, y = next(iter(loader))
    y = torch.as_tensor(y, device="cuda").long()
    model = _small_model(which, "cuda")
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def loss_and_grads(m, b, yy):
        m.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(_logits(m, b), yy)
        loss.backward()
        return loss.detach(), {k: v.grad.detach().float().clone()
                               for k, v in m.named_parameters()}

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(_logits(model, batch), y)
        loss.backward()
        opt.step()
        return loss.detach()

    repeat = step_one_repeats(f"train_{which}",
                              lambda: loss_and_grads(model, batch, y))
    # the main path, counted
    reset_counts()
    step_ms, losses = [], []
    sels, topk = [], which.startswith("aggr_")
    for i in range(SMALL_STEPS):
        if i == 0:
            def first():
                with pinned_selection(record=sels, topk=topk):
                    out = loss_and_grads(model, batch, y)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
            loss0 = float(loss)
        else:
            ms, loss = _timed_step(step)
        step_ms.append(ms)
        losses.append(float(loss))
    launches = read_counts()
    k4_routes = dict(_wrappers()["sorted_segment_sum"].launches_by_route)
    k3_routes = dict(_wrappers()["bmm"].launches_by_route)
    want = dict.fromkeys(launches, 0)
    want.update({k: n * SMALL_STEPS for k, n in SMALL_LAUNCHES[which]
                 .items()})
    if launches != want:
        raise AssertionError(f"{which}: {SMALL_STEPS} steps launched "
                             f"{launches}, want {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{which}: non-finite losses {losses}")

    cpu = _small_model(which, "cpu")
    cpu.load_state_dict(init)
    with pinned_selection(replay=sels, topk=topk):
        cpu_loss, cpu_grads = loss_and_grads(cpu, batch.to("cpu"), y.cpu())
    cpu_loss = float(cpu_loss)
    loss_err, grad_err = _step_one_errors(f"{which}: step one", loss0,
                                          grads0, cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    n_edges = int(batch.edge_mask.sum())
    result = dict(
        card=card, graphs=len(graphs), nodes=int(batch.node_mask.sum()),
        edges=n_edges, edges_sorted=batch.edges_sorted, steps=SMALL_STEPS,
        step_ms=step_ms, step_ms_median=med,
        edges_per_s=n_edges / (med / 1e3), losses=losses,
        launches=launches, k4_launches_by_route=k4_routes,
        k3_launches_by_route=k3_routes,
        k3_launches_per_step=launches["bmm"] / SMALL_STEPS,
        k1_launches_per_step=launches["spmm_csr"] / SMALL_STEPS,
        k4_launches_per_step=launches["sorted_segment_sum"] / SMALL_STEPS,
        step1_loss=loss0, step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, step1_repeat_bit_equal=repeat)
    print(f"[train_{which}] {json.dumps(result)}", flush=True)
    if profile:
        result["profile"] = _idle_profile(step, 3, med, f"train_{which}")
    return result


def _mincut_model(device, alias, seed=0):
    """``PoolingClassifier`` over ``get_pooler(alias)`` (MinCut or BNPool,
    K = 16) at the dense cell's width, f32, its dense GCN products in K3;
    BNPool draws from a generator on ``device`` seeded ``seed + 1``."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    g = torch.Generator().manual_seed(seed)
    sample = torch.Generator(device=device).manual_seed(seed + 1)
    pooler = get_pooler(alias, in_channels=HIDDEN, k=MINCUT_K,
                        device=device, generator=g, sample_generator=sample)
    return PoolingClassifier(pooler, num_classes=CLASSES, hidden=HIDDEN,
                             in_channels=FEATURES, use_kernel=True,
                             device=device, generator=g)


def phase_train_mincut(card, graphs, labels, profile: bool, alias="mincut"):
    """MinCut (or BNPool) trains MINCUT_STEPS Adam steps (f32; CE + the
    pooler's losses: MinCut's cut and ortho, BNPool's quality, kl and
    K_prior) on the dense cell's 64 graphs: batched (``alias="mincut"``,
    ``"bnpool"``) on ``prepare_batch(..., pooler=<instance>,
    normalize=False)``'s dense batch; ``"mincut_u"``/``"bnpool_u"`` on the
    same graphs collated sparse by ``GraphLoader`` (the instance keeps it
    sparse), its pooled graph dense ``[64, 16, 16]``.  The launches a step
    are ``SOFT_LAUNCHES[alias]`` (K3 by route; the unbatched modes' sparse
    sums and gathers on K4); step one repeats bit for bit (BNPool's
    generator restored) and its loss and gradients are held against the
    CPU, which takes the card's Gamma draws and negatives; the losses
    finite."""
    from tgp_tpu_torch import DenseGraphBatch, from_graphs, prepare_batch
    from tgp_tpu_torch.data import GraphLoader

    model = _mincut_model("cuda", alias)
    batched = not alias.endswith("_u")
    if batched:
        raw = from_graphs(graphs, device="cuda")
    else:
        raw, _ = next(iter(GraphLoader(graphs, labels,
                                       batch_size=len(graphs),
                                       device="cuda")))
    batch = prepare_batch(raw, pooler=model.pooler, normalize=False)
    if isinstance(batch, DenseGraphBatch) != batched:
        raise AssertionError(f"{alias}: prepare_batch took the wrong route")
    y = torch.tensor(labels, device="cuda").long()
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    K3 = _wrappers()["bmm"]

    def loss_of(m, b, yy):
        logits, out = m(b)
        return (torch.nn.functional.cross_entropy(logits, yy)
                + out.loss_sum()), out

    def loss_and_grads(m, b, yy):
        m.zero_grad(set_to_none=True)
        loss, out = loss_of(m, b, yy)
        loss.backward()
        return loss.detach(), out, {k: v.grad.detach().float().clone()
                                    for k, v in m.named_parameters()}

    def step():
        opt.zero_grad(set_to_none=True)
        loss, out = loss_of(model, batch, y)
        loss.backward()
        opt.step()
        return loss.detach(), out

    gens = [g for g in (getattr(model.pooler, "sample_generator", None),)
            if g is not None]
    repeat = step_one_repeats(f"train_{alias}",
                              lambda: loss_and_grads(model, batch, y), gens)
    # the main path, counted
    reset_counts()
    step_ms, losses, per_step, aux = [], [], [], []
    draws = []
    for i in range(MINCUT_STEPS):
        before = K3.launches
        if i == 0:
            def first():
                with pinned_draws(record=draws):
                    got = loss_and_grads(model, batch, y)
                opt.step()
                return got

            ms, (loss, out, grads0) = _timed_step(first)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
            loss0 = float(loss)
        else:
            ms, (loss, out) = _timed_step(step)
        step_ms.append(ms)
        losses.append(float(loss))
        per_step.append(K3.launches - before)
        aux.append({k: float(v.detach()) for k, v in out.loss.items()})
    launches = read_counts()
    k3_routes = dict(K3.launches_by_route)
    want = dict.fromkeys(launches, 0)
    want.update({k: n * MINCUT_STEPS for k, n in SOFT_LAUNCHES[alias]
                 .items()})
    if launches != want or per_step != [SOFT_LAUNCHES[alias]["bmm"]] * \
            MINCUT_STEPS:
        raise AssertionError(f"{alias}: {MINCUT_STEPS} steps launched "
                             f"{launches} ({per_step} K3 a step), want "
                             f"{want}")
    if not np.isfinite(losses).all() or not all(
            set(a) == SOFT_LOSSES[alias.removesuffix("_u")]
            and np.isfinite(list(a.values())).all() for a in aux):
        raise AssertionError(f"{alias}: non-finite losses {losses} {aux}")

    cpu = _mincut_model("cpu", alias)
    cpu.load_state_dict(init)
    with pinned_draws(replay=draws):
        cpu_loss, _, cpu_grads = loss_and_grads(cpu, batch.to("cpu"),
                                                y.cpu())
    cpu_loss = float(cpu_loss)
    loss_err, grad_err = _step_one_errors(f"{alias}: step one", loss0,
                                          grads0, cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    result = dict(
        card=card, graphs=len(graphs), k=MINCUT_K, steps=MINCUT_STEPS,
        dense_batch=isinstance(batch, DenseGraphBatch), step_ms=step_ms,
        step_ms_median=med, losses=losses, aux_losses=aux,
        launches=launches, k3_launches_per_step=per_step,
        k3_launches_by_route=k3_routes,
        k4_launches_by_route=dict(
            _wrappers()["sorted_segment_sum"].launches_by_route),
        step1_loss=loss0, step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, step1_repeat_bit_equal=repeat,
        draws_replayed=len(draws))
    tag = f"train_{alias}"
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    if profile:
        result["profile"] = _idle_profile(step, 3, med, tag)
    return result


def phase_dense_family(card, graphs):
    """Each dense soft-cluster pooler, batched and ``_u``, one forward on
    the dense cell's raw graphs (F = 128, K = 16): every loss within
    FAMILY_LOSS_REL_TOL of the same pooler's on the CPU, and the batched
    and unbatched losses, pooled features and pooled adjacency within
    FAMILY_TWIN_TOL of each other on the card."""
    from tgp_tpu_torch import from_graphs, get_pooler, prepare_batch

    inputs = {}
    for dev in ("cuda", "cpu"):
        sparse = from_graphs(graphs, device=dev)
        inputs[dev] = {True: prepare_batch(sparse, densify=True),
                       False: sparse}
    rows = []
    for alias in DENSE_FAMILY:
        outs = {}
        for batched in (True, False):
            for dev in ("cuda", "cpu"):
                pooler = get_pooler(alias, in_channels=FEATURES, k=MINCUT_K,
                                    batched=batched, device=dev,
                                    generator=torch.Generator()
                                    .manual_seed(3))
                with torch.no_grad():
                    if dev == "cuda":
                        ms, out = _timed_step(
                            lambda: pooler(inputs[dev][batched]))
                    else:
                        out = pooler(inputs[dev][batched])
                outs[batched, dev] = out
            mode = "batched" if batched else "u"
            gpu, cpu = outs[batched, "cuda"], outs[batched, "cpu"]
            errs = {k: abs(float(v) - float(cpu.loss[k]))
                    / max(abs(float(cpu.loss[k])), 1e-30)
                    for k, v in gpu.loss.items()}
            bad = {k: e for k, e in errs.items()
                   if not e <= FAMILY_LOSS_REL_TOL}
            if bad or set(gpu.loss) != set(cpu.loss):
                raise AssertionError(f"{alias} {mode}: losses on the card vs "
                                     f"the CPU {bad} > {FAMILY_LOSS_REL_TOL}")
            rows.append(dict(pooler=alias, mode=mode, forward_ms=ms,
                             losses={k: float(v) for k, v in
                                     gpu.loss.items()},
                             loss_rel_err_vs_cpu=errs))
        ob, ou = outs[True, "cuda"], outs[False, "cuda"]
        twin = {}
        for name in ob.loss:
            twin[name] = abs(float(ob.loss[name]) - float(ou.loss[name]))
            if twin[name] > FAMILY_TWIN_TOL * (1 + abs(float(ou.loss[name]))):
                raise AssertionError(f"{alias}: batched {name} "
                                     f"{float(ob.loss[name])} vs _u "
                                     f"{float(ou.loss[name])}")
        for f in ("x", "adj"):
            a, b = getattr(ob.dense, f), getattr(ou.dense, f)
            twin[f] = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=FAMILY_TWIN_TOL,
                                  atol=FAMILY_TWIN_TOL):
                raise AssertionError(f"{alias}: batched and _u pooled {f} "
                                     f"differ by {twin[f]}")
        if not torch.equal(ob.dense.mask, ou.dense.mask):
            raise AssertionError(f"{alias}: batched and _u masks differ")
        rows[-1]["batched_vs_u_max_abs"] = twin
    rows.append(_bnpool_twins(inputs))
    print(f"[dense_family] {json.dumps(dict(card=card, rows=rows))}",
          flush=True)
    return rows


def _bnpool_twins(inputs):
    """BNPool batched and ``_u`` on one forward from shared draws: the
    Gamma draws made once on the card (``[B, Nmax, K − 1]``, read at each
    node's cell for the flat layout) and the ``_u`` negatives drawn once
    on the card, both replayed into every run.  The pooled features and
    adjacency of the two modes within FAMILY_TWIN_TOL of each other; each
    mode's losses within FAMILY_LOSS_REL_TOL of its CPU run.  (The modes'
    losses differ by design: the batched ones normalize by N² over every
    pair, the unbatched ones by the sampled pairs.)"""
    from tgp_tpu_torch import get_pooler
    from tgp_tpu_torch.ops.sampling import negative_edge_sampling

    dense, flat = inputs["cuda"][True], inputs["cuda"][False]
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (dense.num_graphs, dense.max_nodes, MINCUT_K - 1)
    g_dense = [torch._standard_gamma(torch.full(shape, a, device="cuda"),
                                     generator=gen) for a in (2.0, 3.0)]
    cells = flat.node_graph.long() * dense.max_nodes + flat.node_pos.long()
    g_flat = [g.reshape(-1, MINCUT_K - 1)[cells] for g in g_dense]
    neg = negative_edge_sampling(flat, gen)
    replays = {True: [g.cpu() for g in g_dense],
               False: [g.cpu() for g in g_flat] + [tuple(t.cpu()
                                                         for t in neg)]}
    outs, row = {}, dict(pooler="bnpool", mode="batched_vs_u")
    for batched in (True, False):
        for dev in ("cuda", "cpu"):
            pooler = get_pooler("bnpool", in_channels=FEATURES, k=MINCUT_K,
                                batched=batched, device=dev,
                                generator=torch.Generator().manual_seed(3))
            with torch.no_grad(), pinned_draws(replay=replays[batched]):
                outs[batched, dev] = pooler(inputs[dev][batched])
        gpu, cpu = outs[batched, "cuda"], outs[batched, "cpu"]
        errs = {k: abs(float(v) - float(cpu.loss[k]))
                / max(abs(float(cpu.loss[k])), 1e-30)
                for k, v in gpu.loss.items()}
        bad = {k: e for k, e in errs.items() if not e <= FAMILY_LOSS_REL_TOL}
        if bad or set(gpu.loss) != {"quality", "kl", "K_prior"}:
            raise AssertionError(f"bnpool batched={batched}: losses on the "
                                 f"card vs the CPU {bad}")
        mode = "batched" if batched else "u"
        row[f"losses_{mode}"] = {k: float(v) for k, v in gpu.loss.items()}
        row[f"loss_rel_err_vs_cpu_{mode}"] = errs
    ob, ou = outs[True, "cuda"], outs[False, "cuda"]
    twin = {}
    for f in ("x", "adj"):
        a, b = getattr(ob.dense, f), getattr(ou.dense, f)
        twin[f] = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=FAMILY_TWIN_TOL, atol=FAMILY_TWIN_TOL):
            raise AssertionError(f"bnpool: batched and _u pooled {f} differ "
                                 f"by {twin[f]}")
    if not torch.equal(ob.dense.mask, ou.dense.mask):
        raise AssertionError("bnpool: batched and _u masks differ")
    row["batched_vs_u_max_abs"] = twin
    return row


def phase_maxcut_dense(card, graphs, labels):
    """MaxCut's two engines on the ASAP cell's batch (the dense cell's 64
    graphs collated sparse by ``GraphLoader``: B·Nmax² = 4.19M ≤
    ``DENSE_VOTE_BUDGET``, so ``"auto"`` takes the dense engine): one
    forward and backward of ``get_pooler("maxcut", in_channels=128)``
    with ``mp_impl="dense"`` and ``"sparse"`` on the same weights (the
    maxcut loss + ⟨G, x'⟩).  The two engines' scores agree within
    MAXCUT_ENGINE_TOL of the score scale after 12 rounds; the dense
    engine's selection voted by both engines gives the same clusters;
    each engine agrees with its CPU run on the card's selection: scores
    within MAXCUT_ENGINE_TOL, the same clusters, gradients within
    GRAD_REL_TOL of each leaf's scale.  The sparse engine's rounds run on
    K1 (sorted into its layout once a forward), 12 launches forward and
    12 backward.  ``fwd_bwd_ms``: the median of MAXCUT_DENSE_TIMED warm
    forward-and-backward runs (pooler and input built, first run done)
    between CUDA events."""
    from tgp_tpu_torch import get_pooler
    from tgp_tpu_torch.data import GraphLoader
    from tgp_tpu_torch.ops.assignment import assign_all_nodes
    from tgp_tpu_torch.ops.sparse import use_dense_vote
    from tgp_tpu_torch.select.topk import topk_select_from_scores

    batch, _ = next(iter(GraphLoader(graphs, labels, batch_size=len(graphs),
                                     device="cuda")))
    if not use_dense_vote(batch.num_graphs, batch.max_nodes):
        raise AssertionError("the ASAP cell's batch is past the dense budget")

    def engine(impl, device):
        """``(fwd_bwd, grads)``: the pooler and its input built once;
        ``fwd_bwd()`` runs one forward and backward from zeroed gradients
        (``G`` drawn on the first), ``grads()`` copies the gradients."""
        pooler = get_pooler("maxcut", in_channels=FEATURES, ratio=0.5,
                            mp_impl=impl, device=device,
                            generator=torch.Generator().manual_seed(4))
        b = batch.to(device)
        x = b.x.clone().requires_grad_(True)
        bx, G = b.replace(x=x), []

        def fwd_bwd():
            pooler.zero_grad(set_to_none=True)
            x.grad = None
            out = pooler(bx)
            if not G:
                G.append(torch.randn(out.graph.x.shape, generator=torch
                                     .Generator().manual_seed(5)).to(device))
            (out.loss["maxcut_loss"] + (out.graph.x * G[0]).sum()).backward()
            return out

        def grads():
            got = {k: q.grad.cpu() for k, q in pooler.named_parameters()}
            got["x"] = x.grad.cpu()
            return got
        return fwd_bwd, grads

    def run_cpu(impl, replay):
        fwd_bwd, grads = engine(impl, "cpu")
        with pinned_selection(replay=replay):
            out = fwd_bwd()
        return out, grads()

    rows, nm = {}, batch.node_mask
    for impl in ("dense", "sparse"):
        fwd_bwd, grads_of = engine(impl, "cuda")
        sels = []
        reset_counts()
        with pinned_selection(record=sels):
            out = fwd_bwd()
        torch.cuda.synchronize()
        launches = read_counts()
        grads = grads_of()
        want = dict.fromkeys(launches, 0)
        want.update(MAXCUT_DENSE_LAUNCHES[impl])
        if launches != want:
            raise AssertionError(f"maxcut {impl}: launched {launches}, want "
                                 f"{want}")
        # warm: built once, first forward and backward done
        times = [_timed_step(fwd_bwd)[0] for _ in range(MAXCUT_DENSE_TIMED)]
        cpu_out, cpu_grads = run_cpu(impl, sels)
        sc, cpu_sc = out.so.extras["scores"], cpu_out.so.extras["scores"]
        scale = float(cpu_sc.abs().max())
        score_err = float((sc.cpu() - cpu_sc)[nm.cpu()].abs().max()) / scale
        same = torch.equal(out.so.cluster_index.cpu(),
                           cpu_out.so.cluster_index)
        loss_err, grad_err = _step_one_errors(
            f"maxcut {impl}", float(out.loss["maxcut_loss"]), grads,
            float(cpu_out.loss["maxcut_loss"]), cpu_grads)
        if score_err > MAXCUT_ENGINE_TOL or not same:
            raise AssertionError(f"maxcut {impl}: scores {score_err} of the "
                                 f"scale from the CPU's, clusters equal "
                                 f"{same}")
        rows[impl] = dict(fwd_bwd_ms=statistics.median(times),
                          fwd_bwd_ms_all=times, launches=launches,
                          score_rel_err_vs_cpu=score_err,
                          clusters_equal_cpu=same, loss_rel_err=loss_err,
                          grad_rel_err=grad_err, scores=sc, so=out.so)
    d_sc, s_sc = rows["dense"].pop("scores"), rows["sparse"].pop("scores")
    engines = float((d_sc - s_sc)[nm].abs().max() / d_sc[nm].abs().max())
    if engines > MAXCUT_ENGINE_TOL:
        raise AssertionError(f"maxcut: the engines' scores differ by "
                             f"{engines} of the scale")
    so = topk_select_from_scores(d_sc.detach(), batch, 0.5)
    votes = {impl: assign_all_nodes(
        so, batch.senders, batch.receivers, batch.edge_mask,
        node_pos=batch.node_pos, max_nodes=batch.max_nodes,
        impl=impl).cluster_index for impl in ("dense", "sparse")}
    if not torch.equal(votes["dense"], votes["sparse"]):
        raise AssertionError("maxcut: the voting engines disagree on one "
                             "selection")
    for r in rows.values():
        r.pop("so")
    result = dict(card=card, graphs=batch.num_graphs,
                  nodes=int(nm.sum()), edges=int(batch.edge_mask.sum()),
                  engines_score_rel_diff=engines, votes_equal=True,
                  tol=MAXCUT_ENGINE_TOL, **rows)
    print(f"[maxcut_dense] {json.dumps(result)}", flush=True)
    return result


def _so_to(so, device):
    """A ``SelectOutput`` with every tensor field moved to ``device``."""
    import dataclasses

    return so.replace(**{f.name: getattr(so, f.name).to(device)
                         for f in dataclasses.fields(so)
                         if isinstance(getattr(so, f.name), torch.Tensor)})


def _aggr_reduce(alias, device):
    """``AggrReduce(alias)`` at the cell's input width, its weights from a
    fixed generator (``mlp``, ``patch_transformer``: ``max_len`` the
    cell's graph size)."""
    from tgp_tpu_torch.reduce.aggr import AggrReduce

    kw = {"max_len": AGGR_MAX_LEN} if alias in AGGR_SIZED else {}
    return AggrReduce(alias, in_channels=FEATURES, device=device,
                      generator=torch.Generator().manual_seed(0), **kw)


def _aggr_fwd_bwd(mod, x, args, cotangents):
    """One forward and backward of ``mod(x, **args)`` against a fixed
    cotangent (made once a shape and device, kept in ``cotangents``): the
    output, the input's gradient and each parameter's."""
    x = x.detach().clone().requires_grad_(True)
    mod.zero_grad(set_to_none=True)
    out = mod(x, **args)
    key = (tuple(out.shape), out.device)
    if key not in cotangents:
        cotangents[key] = torch.randn(
            out.shape, generator=torch.Generator().manual_seed(12)).to(
                out.device)
    (out * cotangents[key]).sum().backward()
    return (out.detach(), x.grad,
            {k: p.grad for k, p in mod.named_parameters()})


def phase_aggr_zoo(card, graphs, labels):
    """Every alias of ``get_aggr`` (29) through ``AggrReduce`` on the
    dense cell's 64 graphs collated sparse by ``GraphLoader`` (16,384
    rows of 128 f32): as a readout over the 64 graphs, and as a sparse
    reduce under Graclus's assignment of that batch (its weights, its
    16,384 cluster slots).  Each: one forward and backward counted (K4 a
    call), a repeat required bit-equal (output, input and parameter
    gradients), AGGR_TIMED more timed by CUDA events, and the same on the
    CPU: the output within AGGR_TOL (AGGR_RNN_TOL for the recurrent ones)
    of its largest |value|, each gradient within GRAD_REL_TOL of its
    leaf's largest |value|."""
    from tgp_tpu_torch import get_pooler
    from tgp_tpu_torch.data import GraphLoader
    from tgp_tpu_torch.reduce.aggr import aggr_aliases

    batch, _ = next(iter(GraphLoader(graphs, labels,
                                     batch_size=len(graphs), device="cuda")))
    with torch.no_grad():
        so = get_pooler("graclus", device="cuda")(batch).so
    uses = {"readout": dict(so=None, node_graph=batch.node_graph,
                            num_graphs=batch.num_graphs,
                            node_mask=batch.node_mask),
            "graclus": dict(so=so)}
    x = batch.x.float()
    rows, total, cotangents = {}, {}, {}
    for alias in aggr_aliases():
        for use, args in uses.items():
            cpu_args = {k: (_so_to(v, "cpu") if k == "so" and v is not None
                            else v.cpu() if isinstance(v, torch.Tensor)
                            else v) for k, v in args.items()}
            cpu_mod = _aggr_reduce(alias, "cpu")
            mod = _aggr_reduce(alias, "cuda")
            mod.load_state_dict(cpu_mod.state_dict())
            # the main path, counted
            reset_counts()
            first = _aggr_fwd_bwd(mod, x, args, cotangents)
            torch.cuda.synchronize()
            launches = read_counts()
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            again = _aggr_fwd_bwd(mod, x, args, cotangents)
            torch.cuda.synchronize()
            same = (torch.equal(first[0], again[0])
                    and torch.equal(first[1], again[1])
                    and all(torch.equal(g, again[2][k])
                            for k, g in first[2].items()))
            if not same:
                raise AssertionError(f"{alias} {use}: a repeated forward and "
                                     "backward differs")
            ms = statistics.median(
                _timed_step(lambda: _aggr_fwd_bwd(mod, x, args,
                                                  cotangents))[0]
                for _ in range(AGGR_TIMED))
            ref = _aggr_fwd_bwd(cpu_mod, x.cpu(), cpu_args, cotangents)
            tol = AGGR_RNN_TOL if alias in AGGR_RNN else AGGR_TOL
            out_scale = max(float(ref[0].abs().max()), 1e-30)
            out_err = float((first[0].cpu() - ref[0]).abs().max()) / out_scale
            grads = {"x": (first[1], ref[1]),
                     **{k: (g, ref[2][k]) for k, g in first[2].items()}}
            grad_err = {k: float((a.cpu() - b).abs().max()) / max(float(
                (grads[k.replace("bias", "weight")][1]
                 if aggr_zero_grad(alias, k) else b).abs().max()), 1e-30)
                        for k, (a, b) in grads.items()}
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (first[0], first[1], *first[2].values()))
            if (not finite or out_err > tol
                    or max(grad_err.values()) > GRAD_REL_TOL):
                raise AssertionError(
                    f"{alias} {use} on the card vs the CPU: output error "
                    f"{out_err} (tol {tol}), gradient errors {grad_err}")
            rows[f"{alias} {use}"] = dict(
                ms=ms, k4_launches=launches["sorted_segment_sum"],
                out_shape=list(first[0].shape), out_rel_err=out_err,
                out_tol=tol, grad_rel_err=max(grad_err.values()),
                repeat_bit_equal=True)
    if not total.get("sorted_segment_sum"):
        raise AssertionError("the aggregations launched no K4")
    result = dict(card=card, rows=int(batch.node_mask.sum()),
                  edges=int(batch.edge_mask.sum()), graphs=len(graphs),
                  clusters=so.num_clusters,
                  occupied_clusters=int(so.out_mask().sum()),
                  aliases=len(aggr_aliases()), launches=total,
                  grad_rel_tol=GRAD_REL_TOL, per_alias=rows)
    print(f"[aggr_zoo] {json.dumps(result)}", flush=True)
    return result


def phase_serving_aggr(card, graphs, batch, profile: bool, aggr: str):
    """The aggregation example twin's ``Net`` (GCN → top-k → GCN →
    ``AggrReduce(aggr)`` → head, hidden 128, f32) served through
    ``Predictor(batch_size=1, sort_edges=True)`` on the full-size
    requests: K1 3 times a request, K4 ``K4_PER_AGGR_REQUEST[aggr]``
    times; the logits held to the CPU run on the card's replayed top-k
    selection, a repeated request bit-equal, and the readout's recurrent
    steps (the longest segment: the pooled graph's valid nodes)."""
    import torch.nn.functional as F_

    from examples.classification_aggr_reduce_torch import Net
    from tgp_tpu_torch import Predictor, get_pooler

    tag = f"serving_aggr_{aggr}"

    def build(device):
        """The served Net; on the CPU with the card's pooling mode and GCN
        branches (masked pooling keeps the rows in node order, which an
        order-sensitive readout reads; the CSR branches on K1's plain
        version)."""
        g = torch.Generator().manual_seed(0)
        pooler = None if device == "cuda" else get_pooler(
            "topk", in_channels=HIDDEN, ratio=0.5, pool_mode="masked",
            device=device, generator=g)
        net = Net(FEATURES, aggr, num_classes=CLASSES, hidden=HIDDEN,
                  pooler=pooler, device=device, generator=g)
        if device != "cuda":
            net.conv.use_kernel = net.conv_1.use_kernel = True
        return net.eval()

    model = build("cuda")
    predictor = Predictor(model, batch_size=1, sort_edges=True,
                          device="cuda")
    sels = []
    with torch.inference_mode(), pinned_selection(record=sels, topk=True):
        model(batch)  # warm-up: cuDNN and cuBLAS handles, the allocator
    with torch.inference_mode():
        pooled = model.pooler(batch.with_features(F_.relu(model.conv(batch))))
    if pooled.so.extras.get("pool_mode") != "masked":
        raise AssertionError(f"{tag}: the request did not take masked "
                             "pooling")
    steps = int(pooled.graph.node_mask.sum())

    # the main path, counted: the predictor answers every request
    reset_counts()
    req_ms, served = [], []
    for g in graphs:
        t0 = time.perf_counter()
        served.append(predictor([g]))
        req_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts()
    k4_routes = dict(_wrappers()["sorted_segment_sum"].launches_by_route)
    want = dict.fromkeys(launches, 0)
    want.update(spmm_csr=K1_PER_REQUEST["topk"] * REQUESTS,
                sorted_segment_sum=K4_PER_AGGR_REQUEST[aggr] * REQUESTS)
    if launches != want:
        raise AssertionError(f"{tag}: {REQUESTS} requests launched "
                             f"{launches}, want {want}")
    served = np.concatenate(served)
    if served.shape != (REQUESTS, CLASSES) or not np.isfinite(served).all():
        raise AssertionError(f"{tag}: bad logits {served}")
    again = predictor([graphs[0]])
    if not np.array_equal(again[0], served[0]):
        raise AssertionError(f"{tag}: two requests on one graph differ: "
                             f"{again[0]} vs {served[0]}")
    fwd = []
    with torch.inference_mode():
        for _ in range(5):
            fwd.append(_timed_step(lambda: model(batch))[0])

    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode(), pinned_selection(replay=sels, topk=True):
        ref = cpu(batch.to("cpu")).numpy()
    tol = 2e-2 * float(np.abs(ref).max())
    diff = float(np.abs(served[0] - ref[0]).max())
    if diff > tol:
        raise AssertionError(f"{tag}: GPU logits {served[0]} vs CPU "
                             f"{ref[0]}: max |diff| {diff} > {tol}")
    result = dict(
        card=card, requests=REQUESTS, request_ms=req_ms,
        request_ms_median=statistics.median(req_ms),
        forward_device_ms=statistics.median(fwd), forward_device_ms_all=fwd,
        launches=launches,
        k4_launches_by_route=k4_routes, k1_launches_per_request=launches["spmm_csr"] / REQUESTS,
        k4_launches_per_request=launches["sorted_segment_sum"] / REQUESTS,
        recurrent_steps=steps if aggr == "lstm" else None,
        pooled_valid_nodes=steps, logits_first=served[0].tolist(),
        cpu_logits_first=ref[0].tolist(), max_abs_diff_vs_cpu=diff, tol=tol,
        repeat_bit_equal=True, selection_from="card")
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        with torch.inference_mode(), prof(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                model(batch)
            torch.cuda.synchronize()
        print(f"[{tag} profile]", flush=True)
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=25), flush=True)
        busy = sum(e.self_device_time_total for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
        row = dict(forwards=3, device_busy_ms=busy,
                   busy_ms_per_forward=busy / 3)
        print(f"[{tag} profile] {json.dumps(row)}", flush=True)
    return result


def _precoarsened_batch(graphs, labels, schedule_kw, device):
    """``graphs`` through ``PreCoarsening(**schedule_kw)`` on the host
    (seconds taken), and the whole set as one batch of
    ``PooledGraphLoader`` on ``device``: ``(pooled graphs, seconds,
    batch, level batches, labels)``."""
    from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
    from tgp_tpu_torch.precoarsen import PreCoarsening

    tf = PreCoarsening(**schedule_kw)
    t0 = time.perf_counter()
    pooled = [tf(g) for g in graphs]
    secs = time.perf_counter() - t0
    loader = PooledGraphLoader(pooled, labels, batch_size=len(pooled),
                               device=device)
    return (pooled, secs) + tuple(next(iter(loader)))


def _precoarsened_net(device, pooled_graph):
    """The precoarsening twin's ``PrecoarsenedNet`` (hidden 128, f32)
    with weights from a seeded generator, its level widths read from a
    transformed graph."""
    from examples.pre_coarsening_torch import PrecoarsenedNet, level_modes

    return PrecoarsenedNet(FEATURES, CLASSES, hidden=HIDDEN,
                           level_modes=level_modes(pooled_graph),
                           device=device,
                           generator=torch.Generator().manual_seed(0))


def _forward_busy_ms(fn, tag, profile, runs=3):
    """Device busy time of ``runs`` calls of ``fn()`` (the profiler's
    device events), per call; the table with ``profile``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = p.key_averages()
    if profile:
        print(f"[{tag} profile]", flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=25),
              flush=True)
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / runs


def phase_kernels_precoarsen(graphs, d_graphs, d_labels):
    """K4 at the precoarsened paths' shapes: the served request's first
    Graclus level (its cluster sums: the 65,536 f32 rows of 128 into the
    level's cluster slots; the level's GCN aggregation: its normalized
    messages, edges and self-loops, into its nodes) and the trained
    Graclus batch's first level (the ASAP cell's 16,384 rows into its
    cluster slots).  Each held to the plain version at REL_TOL and run
    twice for the same bits; library: ``index_add_``; ``sort_ms``: the
    stable sort and offsets before the kernel."""
    from tgp_tpu_torch.mp.gcn import gcn_norm
    from tgp_tpu_torch.ops.kernels import segment_spmm as K
    from tgp_tpu_torch.ops.segment import _sorted_layout

    serve = _precoarsened_batch(
        graphs[:1], None, dict(poolers="graclus", levels=PRE_SERVING_LEVELS),
        "cuda")
    train = _precoarsened_batch(d_graphs, d_labels,
                                PRE_SCHEDULES["graclus"], "cuda")
    s_lb, t_lb = serve[3][0], train[3][0]
    cases = (("served level reduce", s_lb.so.cluster_index,
              s_lb.so.node_sel_mask, s_lb.so.num_clusters),
             ("served level GCN", gcn_norm(s_lb.graph)[1], None,
              s_lb.graph.num_nodes),
             ("trained level reduce", t_lb.so.cluster_index,
              t_lb.so.node_sel_mask, t_lb.so.num_clusters))
    gen = torch.Generator(device="cuda").manual_seed(8)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for what, ids, keep, B in cases:
        ids = ids.long()
        E, F = ids.shape[0], HIDDEN
        if keep is None:
            keep = torch.ones(E, dtype=torch.bool, device="cuda")
        x = torch.randn(E, F, generator=gen, device="cuda")
        cids = ids.to(torch.int32)
        perm, rp = _sorted_layout(ids, B, False)
        name = f"K4 precoarsen {what} F={F} float32 segments={B}"
        rows[name] = check_mode(
            name, lambda: K.gather_segment_sum(x, perm, keep, cids, rp, B),
            lambda: K.gather_segment_sum_plain(x, perm, keep, rp, B),
            lambda: torch.zeros(B, F, device="cuda").index_add_(
                0, ids, torch.where(keep[:, None], x, 0.0)),
            rel_tol=REL_TOL,
            bound_bytes=4 * E * F + 4 * E + E + 4 * (B + 1) + 4 * B * F,
            flops=E * F, peak=FP32_FLOPS_PER_S,
            scale=K.gather_segment_sum_plain(x.abs(), perm, keep, rp, B),
            flush=flush, note="index_add_ of the kept rows", twice=True,
            extra={"rows": E, "kept": int(keep.sum()),
                   "route": K.segment_route(B, E, F),
                   "sort_ms": median_ms(
                       lambda: _sorted_layout(ids, B, False), flush)})
    del flush
    return rows


def phase_serving_precoarsen(card, graphs, profile: bool):
    """The precoarsened model served on the full-size requests: each
    request is one graph through ``PreCoarsening("graclus", levels=2)``
    on the host (the native matching asserted), collated by
    ``PooledGraphLoader(batch_size=1)`` on the card, and a
    ``PrecoarsenedNet`` forward (hidden 128, f32) whose logits come back
    to the host.  Per request: precoarsen, collate and request ms; K1 and
    K4 counted; a repeated request bit-equal; the logits held against the
    same model and levels on the CPU within 2% of their scale; the busy
    time of a forward, profiled."""
    from tgp_tpu_torch import _native
    from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
    from tgp_tpu_torch.precoarsen import PreCoarsening

    tf = PreCoarsening("graclus", levels=PRE_SERVING_LEVELS)

    def request(g, device, model):
        t0 = time.perf_counter()
        pooled = tf(g)
        t1 = time.perf_counter()
        batch, lbs = next(iter(PooledGraphLoader([pooled], batch_size=1,
                                                 device=device)))
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            logits = model(batch, lbs).cpu().numpy()
        t3 = time.perf_counter()
        return logits, pooled, (batch, lbs), dict(
            precoarsen_ms=1e3 * (t1 - t0), collate_ms=1e3 * (t2 - t1),
            request_ms=1e3 * (t3 - t0))

    first = tf(graphs[0])
    model = _precoarsened_net("cuda", first).eval()
    request(graphs[0], "cuda", model)  # warm-up: handles, allocator

    # the main path, counted: every request, host work included
    reset_counts()
    runs_before = dict(_native.engine_runs)
    served, times, levels = [], [], []
    for g in graphs:
        logits, pooled, (batch, lbs), t = request(g, "cuda", model)
        served.append(logits)
        times.append(t)
        levels.append([int(lv["num_clusters"]) for lv in pooled[-1]])
    launches = read_counts()
    k4_routes = dict(_wrappers()["sorted_segment_sum"].launches_by_route)
    native = {k: v - runs_before[k] for k, v in _native.engine_runs.items()}
    if native != {"native": PRE_SERVING_LEVELS * len(graphs), "numpy": 0}:
        raise AssertionError(f"serving_precoarsen: the host matching ran on "
                             f"{native}, want the native library only")
    want = dict.fromkeys(launches, 0)
    want.update(spmm_csr=len(graphs),
                sorted_segment_sum=K4_PER_PRE_REQUEST * len(graphs))
    if launches != want:
        raise AssertionError(f"serving_precoarsen: {len(graphs)} requests "
                             f"launched {launches}, want {want}")
    served = np.concatenate(served)
    if served.shape != (len(graphs), CLASSES) or not np.isfinite(served).all():
        raise AssertionError(f"serving_precoarsen: bad logits {served}")
    again = request(graphs[0], "cuda", model)[0]
    if not np.array_equal(again[0], served[0]):
        raise AssertionError(f"serving_precoarsen: two requests on one graph "
                             f"differ: {again[0]} vs {served[0]}")
    with torch.inference_mode():
        batch, lbs = next(iter(PooledGraphLoader([first], batch_size=1,
                                                 device="cuda")))
        busy = _forward_busy_ms(lambda: model(batch, lbs),
                                "serving_precoarsen", profile)
    cpu = _precoarsened_net("cpu", first).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref = request(graphs[0], "cpu", cpu)[0]
    tol = 2e-2 * float(np.abs(ref).max())
    diff = float(np.abs(served[0] - ref[0]).max())
    if diff > tol:
        raise AssertionError(f"serving_precoarsen: GPU logits {served[0]} vs "
                             f"CPU {ref[0]}: max |diff| {diff} > {tol}")
    result = dict(
        card=card, requests=len(graphs), levels=PRE_SERVING_LEVELS,
        clusters_per_level=levels, host_engine=native,
        precoarsen_ms=[t["precoarsen_ms"] for t in times],
        collate_ms=[t["collate_ms"] for t in times],
        request_ms=[t["request_ms"] for t in times],
        request_ms_median=statistics.median(t["request_ms"] for t in times),
        busy_ms_per_forward=busy, launches=launches,
        k4_launches_by_route=k4_routes,
        k1_launches_per_request=launches["spmm_csr"] / len(graphs),
        k4_launches_per_request=launches["sorted_segment_sum"] / len(graphs),
        logits_first=served[0].tolist(), cpu_logits_first=ref[0].tolist(),
        max_abs_diff_vs_cpu=diff, tol=tol, repeat_bit_equal=True)
    print(f"[serving_precoarsen] {json.dumps(result)}", flush=True)
    return result


def phase_train_precoarsen(card, graphs, labels, schedule, profile: bool):
    """``PrecoarsenedNet`` (hidden 128, f32) trained PRE_STEPS Adam steps
    on the ASAP cell (the dense cell's 64 graphs, one batch) after
    ``PreCoarsening(**PRE_SCHEDULES[schedule])`` on the host: step one
    repeated bit for bit and held against the CPU, the launches counted
    (no K1 below PALLAS_MIN_EDGES; K4 for every sum), the step median,
    the busy time a step and the idle share."""
    tag = f"train_precoarsen_{schedule}"
    pooled, secs, batch, lbs, y = _precoarsened_batch(
        graphs, labels, PRE_SCHEDULES[schedule], "cuda")
    y = torch.as_tensor(y, device="cuda").long()
    model = _precoarsened_net("cuda", pooled[0])
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def loss_and_grads(m, b, levels, yy):
        m.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(m(b, levels), yy)
        loss.backward()
        return loss.detach(), {k: v.grad.detach().float().clone()
                               for k, v in m.named_parameters()}

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(batch, lbs), y)
        loss.backward()
        opt.step()
        return loss.detach()

    repeat = step_one_repeats(tag, lambda: loss_and_grads(model, batch, lbs,
                                                          y))
    # the main path, counted
    reset_counts()
    step_ms, losses = [], []
    for i in range(PRE_STEPS):
        if i == 0:
            def first():
                out = loss_and_grads(model, batch, lbs, y)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
            loss0 = float(loss)
        else:
            ms, loss = _timed_step(step)
        step_ms.append(ms)
        losses.append(float(loss))
    launches = read_counts()
    k4_routes = dict(_wrappers()["sorted_segment_sum"].launches_by_route)
    want = dict.fromkeys(launches, 0)
    want["sorted_segment_sum"] = PRE_K4_PER_STEP[schedule] * PRE_STEPS
    if launches != want:
        raise AssertionError(f"{tag}: {PRE_STEPS} steps launched "
                             f"{launches}, want {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite losses {losses}")

    cpu = _precoarsened_net("cpu", pooled[0])
    cpu.load_state_dict(init)
    from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
    cb, clbs, cy = next(iter(PooledGraphLoader(
        pooled, labels, batch_size=len(pooled), device="cpu")))
    cpu_loss, cpu_grads = loss_and_grads(cpu, cb, clbs,
                                         torch.as_tensor(cy).long())
    cpu_loss = float(cpu_loss)
    loss_err, grad_err = _step_one_errors(f"{tag}: step one", loss0, grads0,
                                          cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    result = dict(
        card=card, schedule=schedule, graphs=len(graphs),
        nodes=int(batch.node_mask.sum()), edges=int(batch.edge_mask.sum()),
        precoarsen_s=secs,
        clusters_per_level=[int(lb.graph.node_mask.sum()) for lb in lbs],
        level_kinds=[("eigen" if lb.so.num_modes else "dense")
                     if lb.so.assignment is not None else "sparse"
                     for lb in lbs],
        steps=PRE_STEPS, step_ms=step_ms, step_ms_median=med, losses=losses,
        launches=launches, k4_launches_by_route=k4_routes,
        k4_launches_per_step=launches["sorted_segment_sum"] / PRE_STEPS,
        step1_loss=loss0, step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, step1_repeat_bit_equal=repeat)
    result["profile"] = _idle_profile(step, 3, med, tag, table=profile)
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    return result


def phase_host_poolers(card, graphs, labels):
    """``get_pooler`` with ``"ndp"``, ``"nmf"``, ``"sep"`` and
    ``"eigen"`` called eagerly on the ASAP cell's batch on the card (the
    selection on the host, the reduce on the card), against the same call
    on the CPU: the pooled features within HOST_POOL_TOL of their largest
    |value|, the pooled graph and the selection equal; then
    ``lifting=True`` on the pooled features, held the same way (NDP's
    kept nodes get their own rows back).  ms a call: host and device,
    the second of two calls."""
    from tgp_tpu_torch import get_pooler
    from tgp_tpu_torch.data import GraphLoader

    batch, _ = next(iter(GraphLoader(graphs, labels,
                                     batch_size=len(graphs), device="cuda")))
    cpu_batch = batch.to("cpu")
    rows, total = {}, {}

    def close(name, got, ref):
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got.cpu() - ref).abs().max()) / scale
        if not (torch.isfinite(got).all() and err <= HOST_POOL_TOL):
            raise AssertionError(f"host_poolers {name}: card vs CPU "
                                 f"{err} > {HOST_POOL_TOL}")
        return err

    for alias, kw in HOST_POOLERS.items():
        pooler = get_pooler(alias, **kw)
        reset_counts()
        with torch.no_grad():
            out = pooler(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        t0 = time.perf_counter()
        with torch.no_grad():
            pooler(batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        with torch.no_grad():
            ref = pooler(cpu_batch)
        x_err = close(f"{alias} x", out.graph.x, ref.graph.x)
        for f in ("senders", "receivers", "edge_weight", "edge_mask",
                  "node_graph", "node_pos", "node_mask"):
            if not torch.equal(getattr(out.graph, f).cpu(),
                               getattr(ref.graph, f)):
                raise AssertionError(f"host_poolers {alias}: pooled {f} "
                                     "differs from the CPU's")
        sel = (("cluster_index", "weight", "node_sel_mask")
               if out.so.is_sparse else ("assignment",))
        for f in sel:
            if not torch.equal(getattr(out.so, f).cpu(), getattr(ref.so, f)):
                raise AssertionError(f"host_poolers {alias}: selection {f} "
                                     "differs from the CPU's")
        x_pool = out.graph.x
        if not out.so.is_sparse:
            B, K = batch.num_graphs, out.so.num_clusters
            x_pool = x_pool[: B * K].reshape(B, K, -1)
        with torch.no_grad():
            lifted = pooler(batch, so=out.so, lifting=True, x=x_pool)
            lifted_ref = pooler(cpu_batch, so=ref.so, lifting=True,
                                x=x_pool.cpu())
        lift_err = close(f"{alias} lift", lifted, lifted_ref)
        if alias == "ndp":
            keep = out.so.node_sel_mask
            if not (torch.equal(lifted[keep], batch.x[keep])
                    and not lifted[~keep].any()):
                raise AssertionError("host_poolers ndp: the lift of the "
                                     "pooled rows is not the kept rows")
        rows[alias] = dict(ms=ms, launches=launches,
                           clusters=int(out.graph.node_mask.sum()),
                           pooled_edges=int(out.graph.edge_mask.sum()),
                           x_shape=list(out.graph.x.shape),
                           x_rel_err=x_err, lift_rel_err=lift_err)
    result = dict(card=card, graphs=len(graphs),
                  nodes=int(batch.node_mask.sum()), tol=HOST_POOL_TOL,
                  launches=total, per_alias=rows)
    print(f"[host_poolers] {json.dumps(result)}", flush=True)
    return result



def phase_locality(card, graphs):
    """The locality path on the union of ``graphs`` (block-diagonal):
    RCM plans, ``locality_spmm`` with the banded (K5) and default (K2)
    engines, ``spmm_sorted`` (K4) and ``sddmm_banded`` (K6) on the plan,
    each mapped back with ``inv`` and held against the plain product of the
    graph in its own order; then each route's device time."""
    from tgp_tpu_torch.ops.kernels.sddmm import sddmm_banded
    from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_sorted
    from tgp_tpu_torch.ops.ordering import locality_spmm, plan_locality_spmm

    offs = np.cumsum([0] + [x.shape[0] for x, _ in graphs])
    ei = np.concatenate([e + o for (_, e), o in zip(graphs, offs)], 1)
    x = np.concatenate([x for x, _ in graphs])
    N = int(offs[-1])
    t0 = time.perf_counter()
    plans = {e: plan_locality_spmm(ei, N, engine=e, device="cuda")
             for e in ("banded", "auto")}
    plan_ms = 1e3 * (time.perf_counter() - t0) / 2
    p = plans["auto"]
    window = plans["banded"]["window"]
    xp = torch.tensor(x[p["perm"]], device="cuda").to(torch.bfloat16)
    runs = {
        "locality_spmm banded": lambda: locality_spmm(plans["banded"], xp),
        "locality_spmm auto": lambda: locality_spmm(p, xp),
        "spmm_sorted": lambda: spmm_sorted(p["senders"], p["receivers"],
                                           p["row_ptr"], p["edge_weight"],
                                           xp, N),
        "sddmm_banded": lambda: sddmm_banded(xp, xp, p["senders"],
                                             p["receivers"], window=window),
    }
    # the main path, counted: each route once
    reset_counts()
    outs = {name: run() for name, run in runs.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict.fromkeys(launches, 0)
    want.update(spmm_banded=1, segment_sum_sorted=1, sorted_segment_sum=1,
                sddmm_banded=1)
    if launches != want:
        raise AssertionError(f"locality launches {launches}, want {want}")

    # the plain products, in the graph's own order
    s, r = (torch.tensor(a, device="cuda").long() for a in ei)
    xf = torch.tensor(x, device="cuda").to(torch.bfloat16).float()
    ref = torch.zeros(N, FEATURES, device="cuda").index_add_(0, r, xf[s])
    scale = torch.zeros(N, FEATURES, device="cuda").index_add_(
        0, r, xf[s].abs())
    inv = torch.tensor(p["inv"], device="cuda")
    errs = {}
    for name in ("locality_spmm banded", "locality_spmm auto",
                 "spmm_sorted"):
        got = outs[name].float()[inv]
        slack = BF16_ULP if outs[name].dtype == torch.bfloat16 else 0.0
        err = ((got - ref).abs() - slack * ref.abs()).clamp(min=0)
        errs[name] = float((err / (scale + 1e-30)).max())
    ps, pr = p["senders"].long(), p["receivers"].long()
    xpf = xp.float()
    dots = (xpf[ps] * xpf[pr]).sum(-1)
    dot_scale = (xpf[ps].abs() * xpf[pr].abs()).sum(-1)
    errs["sddmm_banded"] = float(((outs["sddmm_banded"] - dots).abs()
                                  / (dot_scale + 1e-30)).max())
    if max(errs.values()) > REL_TOL:
        raise AssertionError(f"locality results vs the plain products: "
                             f"{errs} > {REL_TOL}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = {name: median_ms(run, flush) for name, run in runs.items()}
    del flush
    result = dict(card=card, nodes=N, edges=int(ei.shape[1]),
                  bandwidth=p["bandwidth"], window=window,
                  engines={e: q["engine"] for e, q in plans.items()},
                  plan_ms=plan_ms, launches=launches, rel_err=errs,
                  rel_tol=REL_TOL, device_ms=ms)
    print(f"[locality] {json.dumps(result)}", flush=True)
    return result


# ---------------------------------------------------------------------------
# the clustering, TVGNN and node-classification slice: GTVConv, the
# clustering and autoencoder models, their example twins, the datasets
# and the checkpoints
# ---------------------------------------------------------------------------


def cora_graph():
    """A CSBM at Cora's size, degree and homophily (``CORA``): ``(x [N,
    1433], edge_index, communities)``, about 10.6k directed edges."""
    from tgp_tpu_torch.datasets import CSBMDataset

    return CSBMDataset(**CORA)[0]


def _cluster_setup(which, device):
    """``(model, batch, loss_fn, lr)`` of a new training phase on
    ``device``: the example twins' ``build_model`` and Adam rates, seeded
    ``CLUSTER_SEED``; ``loss_fn(model, batch)`` is the step's loss (the
    pooler's losses, plus masked cross-entropy for node
    classification)."""
    import examples.clustering_torch as cl
    import examples.clustering_tvgnn_torch as tv
    import examples.node_class_torch as nc
    from tgp_tpu_torch import from_graphs

    if which in ("cluster_mincut", "tvgnn"):
        x, ei, _ = cora_graph()
        batch = from_graphs([(x, ei)], device=device)
        if which == "cluster_mincut":
            model = cl.build_model("mincut", CLUSTER_HIDDEN, x.shape[1],
                                   k=CORA_K, device=device,
                                   seed=CLUSTER_SEED)
            lr = 5e-4
        else:
            model = tv.build_model(CLUSTER_HIDDEN, x.shape[1], k=CORA_K,
                                   device=device, seed=CLUSTER_SEED)
            lr = 1e-3
    else:
        x, ei = request_graph(7)
        batch = from_graphs([(x, ei)], sort_edges=True, device=device)
        if which == "tvgnn_large":
            model = tv.build_model(CLUSTER_HIDDEN, FEATURES, k=LARGE_K,
                                   device=device, seed=CLUSTER_SEED,
                                   alias="acc_u")
            lr = 1e-3
        else:
            model = nc.build_model("topk", NODE_CLASSES, CLUSTER_HIDDEN,
                                   FEATURES, device=device,
                                   seed=CLUSTER_SEED)
            lr = 5e-3
    if which != "node_class_large":
        return model, batch, lambda m, b: m(b)[1].loss_sum(), lr
    rng = np.random.default_rng(CLUSTER_SEED)
    n = x.shape[0]
    y = torch.as_tensor(rng.integers(0, NODE_CLASSES, n), device=device)
    train = torch.as_tensor(rng.random(n) < 0.5, device=device)

    def loss_fn(m, b):
        logits, out = m(b)
        return nc.masked_ce(logits[:n], y, train) + out.loss_sum()

    return model, batch, loss_fn, lr


def _loss_and_grads(model, batch, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    return loss.detach(), {k: v.grad.detach().float().clone()
                           for k, v in model.named_parameters()}


def phase_train_cluster(card, which, profile: bool):
    """CLUSTER_TRAIN_STEPS Adam steps (f32) of a model of this slice:
    ``"cluster_mincut"`` (``ClusteringModel``, GCN, MinCut, k = 7) and
    ``"tvgnn"`` (GTVConv, AsymCheegerCut, k = 7) on the Cora-sized CSBM
    (below PALLAS_MIN_EDGES: no K1, the fixed-order sums on K4);
    ``"tvgnn_large"`` (GTVConv's CSR route, ``acc_u``, k = 4) and
    ``"node_class_large"`` (``PoolLiftNodeClassifier`` with top-k, 4
    classes, half the nodes labelled) on the serving graph collated with
    ``sort_edges=True`` (K1).  Step one is repeated bit for bit and held
    against the CPU (node classification on the card's replayed top-k
    selection); the launches a step are ``CLUSTER_LAUNCHES[which]``; the
    step median, the busy time of a step and the idle share."""
    tag = f"train_{which}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, batch, loss_fn, lr = _cluster_setup(which, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    topk = which == "node_class_large"
    repeat = step_one_repeats(
        tag, lambda: _loss_and_grads(model, batch, loss_fn))

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    reset_counts()
    step_ms, losses, per_step, sels = [], [], [], []
    for i in range(CLUSTER_TRAIN_STEPS):
        before = read_counts()
        if i == 0:  # step one keeps its gradients for the CPU check
            def first():
                with pinned_selection(record=sels, topk=topk):
                    out = _loss_and_grads(model, batch, loss_fn)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            loss0 = float(loss)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
        else:
            ms, loss = _timed_step(step)
        step_ms.append(ms)
        losses.append(float(loss))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    launches = read_counts()
    want = CLUSTER_LAUNCHES[which]
    if per_step != [want] * CLUSTER_TRAIN_STEPS:
        raise AssertionError(f"{tag}: launches a step {per_step}, want "
                             f"{want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite losses {losses}")

    cpu, cpu_batch, cpu_loss_fn, _ = _cluster_setup(which, "cpu")
    cpu.load_state_dict(init)
    t0 = time.perf_counter()
    with pinned_selection(replay=sels, topk=topk):
        cpu_loss, cpu_grads = _loss_and_grads(cpu, cpu_batch, cpu_loss_fn)
    cpu_s = time.perf_counter() - t0
    cpu_loss = float(cpu_loss)
    loss_err, grad_err = _step_one_errors(f"{tag} step one", loss0, grads0,
                                          cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    busy = _idle_profile(step, 3, med, tag, table=profile)
    n_edges = int(batch.edge_mask.sum())
    result = dict(
        card=card, nodes=int(batch.node_mask.sum()), edges=n_edges,
        edge_slots=batch.num_edges, features=batch.num_features,
        hidden=CLUSTER_HIDDEN, steps=CLUSTER_TRAIN_STEPS, setup_s=setup_s,
        step_ms=step_ms, step_ms_median=med,
        busy_ms_per_step=busy["busy_ms_per_step"],
        idle_share=busy["idle_share"], losses=losses, launches=launches,
        launches_per_step=per_step[0], step1_loss=loss0,
        step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL, cpu_check_s=cpu_s,
        step1_repeat_bit_equal=repeat,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    return result, model, batch


def phase_cluster_examples(card):
    """Each twin's ``main`` at the JAX example's defaults, on the card and
    on the CPU: clustering with ``mincut`` and ``mincut_u`` (150 epochs),
    TVGNN (200) and node classification with ``topk`` (100); the NMI or
    test accuracy against the JAX smoke tests' bounds (NMI > 0.5, accuracy
    > 0.6), which the card's run must pass.  Kernel launches counted."""
    from examples.clustering_torch import main as cluster
    from examples.clustering_tvgnn_torch import main as tvgnn
    from examples.node_class_torch import main as node_class

    runs = (("clustering", "mincut", lambda d: cluster("mincut", verbose=False,
                                                       device=d), "nmi"),
            ("clustering", "mincut_u",
             lambda d: cluster("mincut_u", verbose=False, device=d), "nmi"),
            ("clustering_tvgnn", "acc", lambda d: tvgnn(verbose=False,
                                                        device=d), "nmi"),
            ("node_class", "topk", lambda d: node_class("topk", verbose=False,
                                                        device=d), "acc"))
    reset_counts()
    rows = []
    for example, alias, run, metric in runs:
        before = read_counts()
        t0 = time.perf_counter()
        got = run("cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        after = read_counts()
        t0 = time.perf_counter()
        cpu = run("cpu")
        bound = NMI_BOUND if metric == "nmi" else ACC_BOUND
        row = dict(example=example, alias=alias, metric=metric, card=got,
                   cpu=cpu, jax_test_bound=bound, card_s=card_s,
                   cpu_s=time.perf_counter() - t0,
                   launches={k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
        print(f"[cluster_examples] {json.dumps(row)}", flush=True)
        if not got > bound:
            raise AssertionError(f"{example} {alias}: {metric} {got} on the "
                                 f"card, not above the JAX test's {bound}")
        rows.append(row)
    return dict(card=card, rows=rows, launches=read_counts())


def phase_kernels_gtv(batch):
    """K1 at GTVConv's CSR route on the serving graph (F = CLUSTER_HIDDEN,
    f32): the forward over the collator's sender-sorted transpose layout
    with γ as weights (``out[s] = Σ γ_e h[r_e]``), and the backward's K1
    pass over the receiver-sorted layout (``d_h``) with ``d_w``'s
    gathered dot product beside it (``d_w_ms``, held to the plain
    autograd's ``d_w``); each beside ``torch.sparse.mm`` over the same
    layout, run twice and required bit-equal."""
    from tgp_tpu_torch.mp.gtvconv import _gamma
    from tgp_tpu_torch.ops.kernels import segment_spmm as K

    N, E, F = batch.num_nodes, batch.num_edges, CLUSTER_HIDDEN
    rows = batch.row_ptr.shape[0] - 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    h = torch.randn(N, F, generator=gen, device="cuda")
    s_t, r_t = batch.senders_t, batch.receivers_t
    gamma_t = _gamma(h[s_t.long()], h[r_t.long()],
                     batch.edge_weight_t.float(), 1e-3).contiguous()
    w = torch.where(batch.edge_mask, batch.edge_weight, 0.0).float()
    gamma = _gamma(h[batch.senders.long()], h[batch.receivers.long()], w,
                   1e-3).contiguous()
    csr_bytes = 4 * (2 * E + rows + 1)
    modes = {}
    a_t = torch.sparse_csr_tensor(batch.row_ptr_t, r_t, gamma_t,
                                  size=(rows, N), check_invariants=False)
    name = f"K1 spmm_csr GTV forward F={F} float32"
    modes[name] = check_mode(
        name, lambda: K.spmm_csr(h, gamma_t, None, r_t, None,
                                 batch.row_ptr_t, None, None, None, N),
        lambda: K.spmm_csr_plain(h, gamma_t, r_t, batch.row_ptr_t, N),
        lambda: torch.sparse.mm(a_t, h), rel_tol=REL_TOL,
        bound_bytes=csr_bytes + 2 * N * F * 4, flops=2 * E * F,
        peak=FP32_FLOPS_PER_S,
        scale=K.spmm_csr_plain(h.abs(), gamma_t.abs(), r_t,
                               batch.row_ptr_t, N),
        flush=flush, gather_bytes=E * F * 4, twice=True)

    # the backward: d_h = Γᵀg over the receiver-sorted layout (K1), d_w =
    # ⟨h[r_t], g[s_t]⟩ (the wrapper's gathered dot product)
    g = torch.randn(N, F, generator=gen, device="cuda")
    layout = (r_t, s_t, batch.row_ptr_t, batch.senders, None, batch.row_ptr,
              N)
    hw = h.clone().requires_grad_(True)
    gw = gamma_t.clone().requires_grad_(True)
    K.spmm_csr(hw, gw, gamma, *layout).backward(g)
    hp = h.clone().requires_grad_(True)
    gp = gamma_t.clone().requires_grad_(True)
    K.spmm_csr_plain(hp, gp, r_t, batch.row_ptr_t, N).backward(g)
    dw_err = float((gw.grad - gp.grad).abs().max())
    dw_scale = float((h[r_t.long()].abs() * g[s_t.long()].abs()).sum(-1)
                     .max())
    if not dw_err <= REL_TOL * dw_scale:
        raise AssertionError(f"GTV d_w: max |err| {dw_err} > {REL_TOL} of "
                             f"{dw_scale}")
    rp = batch.row_ptr
    a = torch.sparse_csr_tensor(rp, batch.senders, gamma, size=(rows, N),
                                check_invariants=False)
    name = f"K1 spmm_csr GTV backward d_h F={F} float32"

    def d_w():
        return (h[r_t.long()] * g[s_t.long()]).sum(-1)

    modes[name] = check_mode(
        name, lambda: K.spmm_csr(g, gamma, None, batch.senders, None, rp,
                                 None, None, None, N),
        lambda: K.spmm_csr_plain(g, gamma, batch.senders, rp, N),
        lambda: torch.sparse.mm(a, g), rel_tol=REL_TOL,
        bound_bytes=csr_bytes + 2 * N * F * 4, flops=2 * E * F,
        peak=FP32_FLOPS_PER_S,
        scale=K.spmm_csr_plain(g.abs(), gamma.abs(), batch.senders, rp, N),
        flush=flush, gather_bytes=E * F * 4, twice=True,
        extra={"d_w_ms": median_ms(d_w, flush), "d_w_max_abs_err": dw_err,
               "d_w_bound_ms": 1e3 * (2 * N * F * 4 + 4 * 3 * E)
               / HBM_BYTES_PER_S})
    del flush
    return modes


def phase_checkpoint(card, model, batch, graphs):
    """A trained ``ClusteringModel`` saved (``save_params``) and restored
    into a fresh model on the card: its ``s`` bit-equal; and a
    ``PrecoarsenCache`` hit (Graclus, two levels, on the dense cell's
    first 8 graphs) equal to the cold transform, level by level."""
    import tempfile

    import examples.clustering_tvgnn_torch as tv
    from tgp_tpu_torch.precoarsen import PreCoarsening
    from tgp_tpu_torch.utils.checkpoint import (PrecoarsenCache,
                                                restore_params, save_params)

    model.eval()
    with torch.no_grad():
        s0 = model(batch)[0]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_params(tmp, model)
        save_ms = 1e3 * (time.perf_counter() - t0)
        fresh = tv.build_model(CLUSTER_HIDDEN, batch.num_features, k=CORA_K,
                               device="cuda", seed=CLUSTER_SEED + 1)
        t0 = time.perf_counter()
        restore_params(tmp, like=fresh).eval()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        size = path.stat().st_size
        with torch.no_grad():
            s1 = fresh(batch)[0]
        if not torch.equal(s0, s1):
            raise AssertionError("restored model's s differs: max |diff| "
                                 f"{float((s0 - s1).abs().max())}")
        cache = PrecoarsenCache(root=f"{tmp}/cache")
        tf = PreCoarsening(poolers="graclus", levels=2)
        few = [(x, ei) for x, ei in graphs[:8]]
        cold = [tf(g) for g in few]
        t0 = time.perf_counter()
        cache.precoarsen_with_cache(tf, few)
        miss_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        hit = cache.precoarsen_with_cache(tf, few)
        hit_ms = 1e3 * (time.perf_counter() - t0)
    for c, h in zip(cold, hit):
        for lc, lh in zip(c[-1], h[-1]):
            for k in lc:
                if not np.array_equal(np.asarray(lc[k]), np.asarray(lh[k])):
                    raise AssertionError(f"cache hit differs at {k}")
    row = dict(card=card, params_bytes=size, save_ms=save_ms,
               restore_ms=restore_ms, s_bit_equal=True,
               cache_graphs=len(few), cache_miss_ms=miss_ms,
               cache_hit_ms=hit_ms, cache_hit_equal=True)
    print(f"[checkpoint] {json.dumps(row)}", flush=True)
    return row


def phase_train_tu(card):
    """The classification twin on the TU fixture ``PROTEINS_SYN`` (600
    graphs) through ``load_dataset``, with top-k, for one epoch on the
    card: its test accuracy and the launches."""
    import examples.classification_torch as ex

    reset_counts()
    t0 = time.perf_counter()
    acc = ex.main("topk", epochs=1, verbose=False, dataset="PROTEINS_SYN",
                  data_dir="tests/fixtures/tu", device="cuda")
    torch.cuda.synchronize()
    graphs, _, _ = ex.load_dataset("PROTEINS_SYN", "tests/fixtures/tu")
    row = dict(card=card, graphs=len(graphs),
               nodes=sum(g[0].shape[0] for g in graphs),
               edges=sum(g[1].shape[1] for g in graphs), epochs=1,
               route=ex.LAST_ROUTE, test_acc=acc,
               seconds=time.perf_counter() - t0, launches=read_counts())
    print(f"[train_tu] {json.dumps(row)}", flush=True)
    if not np.isfinite(acc):
        raise AssertionError(f"train_tu: accuracy {acc}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of three forwards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from tgp_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    card = CARD = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)}",
          flush=True)
    for name, (secs, log) in built.items():
        kernels = ptxas_kernels(log)
        spilling = sum(k["spill_stores"] + k["spill_loads"] > 0
                       for k in kernels)
        print(f"[build] {name}: {secs:.2f} s; {len(kernels)} kernels, "
              f"{spilling} spilling; " + " | ".join(
                  f"{k['kernel']}: {k['registers']} registers, "
                  f"{k['stack_frame']} B stack frame, {k['spill_stores']} B "
                  f"spill stores, {k['spill_loads']} B spill loads"
                  for k in kernels), flush=True)

    from tgp_tpu_torch import from_graphs
    from tgp_tpu_torch.models.inference import geometric_budget

    # the first request collated as Predictor buckets it (timed: the
    # collation is part of every request; the CUDA context is made first)
    graphs = [request_graph(7 + i) for i in range(REQUESTS)]
    pn = geometric_budget(N_NODES, 64)
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = from_graphs(graphs[:1], pad_nodes=pn,
                        pad_edges=geometric_budget(N_EDGES, 256),
                        max_nodes=pn, sort_edges=True, device="cuda")
    torch.cuda.synchronize()
    collate_ms = 1e3 * (time.perf_counter() - t0)
    modes = phase_kernels(batch)
    d_graphs, d_labels = dense_graphs(0)
    modes.update(phase_kernels_readout(batch, d_graphs))
    modes.update(phase_kernels_gather_grad(batch, d_graphs, d_labels))
    modes.update(phase_kernels_aggr(batch, d_graphs, d_labels))
    modes.update(phase_kernels_precoarsen(graphs, d_graphs, d_labels))

    # the dense training slice's batch (bench.py::bench_jax): collated,
    # densified and normalized once, outside the steps
    from tgp_tpu_torch import gcn_norm_dense, to_dense

    d_batch = from_graphs(d_graphs, device="cuda")
    n_dense_edges = int(d_batch.edge_mask.sum())
    dense = gcn_norm_dense(to_dense(d_batch), adj_dtype=torch.bfloat16)
    k3_modes = phase_kernels_k3(dense.adj)
    band_modes = phase_kernels_banded()
    modes.update(band_modes)

    serving = phase_serving(card, graphs, batch, collate_ms, args.profile)
    train = phase_train_dense(card, dense,
                              torch.tensor(d_labels, device="cuda").long(),
                              n_dense_edges, args.profile)
    phase_train_default(card, d_graphs, d_labels)
    sparse = phase_train_sparse(card, args.profile)
    serving_sag = phase_serving(card, graphs, batch, collate_ms,
                                args.profile, alias="sag")
    train_sag = phase_train_sparse(card, args.profile, alias="sag")
    small = {which: phase_train_small(card, d_graphs, d_labels, which,
                                      args.profile)
             for which in ("asap", "pan")}
    serving_cl = {alias: phase_serving(card, graphs, batch, collate_ms,
                                       args.profile, alias=alias)
                  for alias in CLUSTERS}
    train_cl = {alias: phase_train_sparse(card, args.profile, alias=alias)
                for alias in ("ec", "kmis")}
    small["lap"] = phase_train_small(card, d_graphs, d_labels, "lap",
                                     args.profile)
    serving_mc = phase_serving(card, graphs, batch, collate_ms,
                               args.profile, alias="maxcut")
    train_mc = phase_train_sparse(card, args.profile, alias="maxcut")
    phase_maxcut_dense(card, d_graphs, d_labels)
    mincut = {alias: phase_train_mincut(card, d_graphs, d_labels,
                                        args.profile, alias)
              for alias in ("mincut", "mincut_u", "bnpool", "bnpool_u")}
    phase_dense_family(card, d_graphs)
    zoo = phase_aggr_zoo(card, d_graphs, d_labels)
    small.update({f"aggr_{a}": phase_train_small(card, d_graphs, d_labels,
                                                  f"aggr_{a}", args.profile)
                  for a in TRAIN_AGGRS})
    serving_aggr = {a: phase_serving_aggr(card, graphs, batch, args.profile,
                                          a) for a in SERVING_AGGRS}
    serving_pre = phase_serving_precoarsen(card, graphs, args.profile)
    train_pre = {sch: phase_train_precoarsen(card, d_graphs, d_labels, sch,
                                             args.profile)
                 for sch in PRE_SCHEDULES}
    host_pools = phase_host_poolers(card, d_graphs, d_labels)
    locality = phase_locality(card, d_graphs)
    modes.update(phase_kernels_gtv(batch))
    cluster_ex = phase_cluster_examples(card)
    cluster_train = {}
    for which in CLUSTER_PHASES:
        cluster_train[which], model, m_batch = phase_train_cluster(
            card, which, args.profile)
        if which == "tvgnn":
            phase_checkpoint(card, model, m_batch, d_graphs)
        del model, m_batch
    train_tu = phase_train_tu(card)
    # the main paths' launches, each kernel summed over every path that
    # runs it (and K2 in the locality path)
    all_runs = (serving, sparse, serving_sag, train_sag, *small.values(),
                *serving_cl.values(), *train_cl.values(), train,
                serving_mc, train_mc, *mincut.values(), zoo,
                *serving_aggr.values(), serving_pre, *train_pre.values(),
                host_pools, cluster_ex, *cluster_train.values(), train_tu)

    def entry(name, source, replaces, launches, mode):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=mode["max_abs_err"], ms=mode["ms"],
                    plain_ms=mode["plain_ms"], bound_ms=mode["bound_ms"],
                    bound_by=mode["bound_by"],
                    library_ms=mode["library_ms"])

    loc = locality["launches"]

    def total(name):
        return sum(r["launches"][name] for r in all_runs)

    kernels = [
        entry("spmm_csr", SOURCE, REPLACES, total("spmm_csr"),
              modes[f"K1 spmm_csr F={FEATURES} bfloat16"]),
        entry("segment_sum_sorted", SOURCE, K2_REPLACES,
              loc["segment_sum_sorted"] + total("segment_sum_sorted"),
              modes[f"K2 segment_sum_sorted F={FEATURES} bfloat16"]),
        entry("bmm", K3_SOURCE, K3_REPLACES, total("bmm"),
              k3_modes["fwd pre"]),
        entry("sorted_segment_sum", K4_SOURCE, K4_REPLACES,
              total("sorted_segment_sum"),
              modes[f"K4 readout F={HIDDEN} float32 segments=1"]),
        entry("spmm_banded", K5_SOURCE, K5_REPLACES, loc["spmm_banded"],
              next(m for k, m in band_modes.items() if k.startswith("K5"))),
        entry("sddmm_banded", K6_SOURCE, K6_REPLACES, loc["sddmm_banded"],
              next(m for k, m in band_modes.items() if k.startswith("K6")))]
    print(f"[modes] {json.dumps(list(modes.values()) + list(k3_modes.values()))}",
          flush=True)
    runs = (("serving", serving, f"{REQUESTS} requests"),
            ("sparse training", sparse, f"{SPARSE_STEPS} steps"),
            ("SAG serving", serving_sag, f"{REQUESTS} requests"),
            ("SAG training", train_sag, f"{SAG_STEPS} steps"),
            ("ASAP training", small["asap"], f"{SMALL_STEPS} steps"),
            ("PAN training", small["pan"], f"{SMALL_STEPS} steps"),
            *((f"{alias} serving", r, f"{REQUESTS} requests")
              for alias, r in serving_cl.items()),
            *((f"{alias} training", r, f"{CLUSTER_STEPS} steps")
              for alias, r in train_cl.items()),
            ("dense training", train, f"{DENSE_STEPS} steps"),
            ("LaPool training", small["lap"], f"{SMALL_STEPS} steps"),
            ("maxcut serving", serving_mc, f"{REQUESTS} requests"),
            ("maxcut training", train_mc, f"{CLUSTER_STEPS} steps"),
            *((f"{alias} training", r, f"{MINCUT_STEPS} steps")
              for alias, r in mincut.items()),
            ("aggregation zoo", zoo,
             f"{2 * zoo['aliases']} forwards and backwards"),
            *((f"{a} readout training", small[f"aggr_{a}"],
               f"{SMALL_STEPS} steps") for a in TRAIN_AGGRS),
            *((f"{a} readout serving", r, f"{REQUESTS} requests")
              for a, r in serving_aggr.items()),
            ("precoarsened serving", serving_pre, f"{REQUESTS} requests"),
            *((f"precoarsened {sch} training", r, f"{PRE_STEPS} steps")
              for sch, r in train_pre.items()),
            ("host poolers", host_pools,
             f"{len(HOST_POOLERS)} eager calls"),
            ("cluster examples", cluster_ex,
             f"{len(cluster_ex['rows'])} twins at their defaults"),
            *((f"{which} training", r, f"{CLUSTER_TRAIN_STEPS} steps")
              for which, r in cluster_train.items()),
            ("TU training", train_tu, "1 epoch"))
    print("launches: " + "; ".join(
        f"{name} K1 {r['launches']['spmm_csr']}, K2 "
        f"{r['launches']['segment_sum_sorted']}, K3 "
        f"{r['launches']['bmm']}, K4 "
        f"{r['launches']['sorted_segment_sum']} for {unit}"
        for name, r, unit in runs), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
