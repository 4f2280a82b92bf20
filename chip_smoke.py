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
12. the locality path on the union of the dense graphs (16,384 nodes):
   ``plan_locality_spmm`` (RCM) and ``locality_spmm`` with the banded
   engine (K5) and the default one (K2), ``spmm_sorted`` (K4) and
   ``sddmm_banded`` (K6) on the same plan, each held against the plain
   product of the graph in its own order.

Every ``[kernels]`` row carries the card's ``nvidia-smi`` name and power
limit; the kernels line counts K1's launches in sparse training, SAG's
and the clustering poolers' serving and training, K2's in the clustering
poolers' and the locality path, K4's in all of those and in ASAP's and
PAN's steps, K3's in dense training, LaPool's and MinCut's steps; the
``launches:`` line gives each path's K1, K2, K3 and K4.  K3's
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
K1_PER_REQUEST = {"topk": 3, "sag": 4, "graclus": 1, "kmis": 1, "ec": 1}
K1_PER_TRAIN_STEP = {"topk": K1_PER_STEP, "sag": K1_PER_STEP + 2,
                     "kmis": 2, "ec": 2}
K4_WIDE_PER_FORWARD = {"topk": 0, "sag": 0, "graclus": 2, "kmis": 3,
                       "ec": 3}
K2_PER_FORWARD = {"topk": 0, "sag": 0, "graclus": 2, "kmis": 2, "ec": 2}
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
SMALL_LAUNCHES = {"asap": {"sorted_segment_sum": 1},
                  # PANConv's to_dense sums duplicate edges on K4 too
                  "pan": {"sorted_segment_sum": 2},
                  "lap": {"bmm": K3_PER_LAP_STEP}}
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
K3_PER_MINCUT_STEP = {"mincut": 5, "mincut_u": 3}
# [dense_family]: each loss on the card within this of the CPU's
# (relative), and batched against "_u" within the contract of
# tests/poolers/test_dense_batched_vs_unbatched.py (rtol = atol)
FAMILY_LOSS_REL_TOL, FAMILY_TWIN_TOL = 1e-4, 5e-4
# K3 above the grid's z limit of 65,535 products: split into launches
K3_SPLIT_BATCH = 70_000


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
    model = build_model("cuda", alias=alias).eval()
    predictor = Predictor(lambda b: model(b)[0], batch_size=1,
                          sort_edges=True, device="cuda")
    ranks = []
    with torch.inference_mode(), pinned_ranks(record=ranks):
        logits, out = model(batch)  # warm-up: cuBLAS handles, allocator
    if not clustering and out.so.extras.get("pool_mode") != "masked":
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
    with torch.inference_mode(), pinned_ranks(replay=ranks):
        ref, ref_out = cpu_model(batch.to("cpu"))
    ref = ref.numpy()
    tol = 2e-2 * float(np.abs(ref).max())
    diff = float(np.abs(served[0] - ref[0]).max())
    if (not clustering and ref_out.so.extras.get("pool_mode") != "masked"
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


def _step_one_grads(model, batch, y):
    """Loss and gradients (copies, on the model's device) of one step,
    without the update."""
    model.zero_grad(set_to_none=True)
    logits, _ = model(batch)
    loss = torch.nn.functional.cross_entropy(logits, y)
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


def _idle_profile(step, steps, med_ms, tag):
    """Profile ``steps`` calls of ``step()`` and print the kernel table
    and the device's busy time a step; the idle share of an unprofiled
    step is 1 − (busy per step) / (its median time ``med_ms``)."""
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
    if not clustering and out.so.extras.get("pool_mode") != "masked":
        raise AssertionError("the training graph did not take masked pooling")
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    K1 = _wrappers()["spmm_csr"]
    K4 = _wrappers()["sorted_segment_sum"]

    # the main path, counted: K1 k1_per_step times a step and K4 (the
    # readout) once, on its "long" route
    reset_counts()
    step_ms, losses, per_step, k4_per_step = [], [], [], []
    ranks = []
    for i in range(steps):
        before, k4_before = K1.launches, K4.launches_by_route["long"]
        if i == 0:  # step one keeps its gradients for the CPU check
            def first():
                with pinned_ranks(record=ranks):
                    out = _step_one_grads(model, batch, y)
                opt.step()
                return out

            ms, (loss, grads0) = _timed_step(first)
            loss0 = float(loss)
            grads0 = {k: v.cpu() for k, v in grads0.items()}
        else:
            ms, loss = _timed_step(
                lambda: _train_step(model, opt, batch, y, aux=False))
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
                sorted_segment_sum=(1 + K4_WIDE_PER_FORWARD[alias]) * steps,
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
    with pinned_ranks(replay=ranks):
        cpu_loss, cpu_grads = _step_one_grads(cpu, batch.to("cpu"),
                                              y.cpu())
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
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] {json.dumps(result)}", flush=True)
    if profile:
        result["profile"] = _idle_profile(
            lambda: _train_step(model, opt, batch, y, aux=False), 3, med,
            tag)
    return result


def _small_model(which, device, seed=0):
    """The example twins' models at the dense cell's width: the
    classification example's ``PoolingClassifier`` with ASAP, or with
    LaPool and its dense pooled graph's products in K3, or ``PANNet``;
    ``logits(model, batch)`` reads each one's logits."""
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
    """ASAP (``which="asap"``), PAN or LaPool (``"lap"``) trains
    SMALL_STEPS Adam steps (f32) through the example twin's model on the
    dense cell's 64 graphs, collated sparse by ``GraphLoader``; below
    PALLAS_MIN_EDGES no K1 runs; the launches a step are
    ``SMALL_LAUNCHES[which]`` (the readout's K4 once; LaPool's dense
    pooled graph K3 three times, by route); step one held against the
    CPU."""
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

    # the main path, counted
    reset_counts()
    step_ms, losses = [], []
    for i in range(SMALL_STEPS):
        if i == 0:
            def first():
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
        grad_rel_tol=GRAD_REL_TOL)
    print(f"[train_{which}] {json.dumps(result)}", flush=True)
    if profile:
        result["profile"] = _idle_profile(step, 3, med, f"train_{which}")
    return result


def _mincut_model(device, alias, seed=0):
    """``PoolingClassifier`` over ``get_pooler(alias)`` (MinCut, K = 16)
    at the dense cell's width, f32, its dense GCN products in K3."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    g = torch.Generator().manual_seed(seed)
    pooler = get_pooler(alias, in_channels=HIDDEN, k=MINCUT_K,
                        device=device, generator=g)
    return PoolingClassifier(pooler, num_classes=CLASSES, hidden=HIDDEN,
                             in_channels=FEATURES, use_kernel=True,
                             device=device, generator=g)


def phase_train_mincut(card, graphs, labels, profile: bool, alias="mincut"):
    """MinCut trains MINCUT_STEPS Adam steps (f32; CE + the pooler's cut
    and ortho losses) on the dense cell's 64 graphs: batched
    (``alias="mincut"``) on ``prepare_batch(..., pooler=<instance>,
    normalize=False)``'s dense batch; ``"mincut_u"`` on the same graphs
    collated sparse by ``GraphLoader`` (the instance keeps it sparse), its
    pooled graph dense ``[64, 16, 16]``.  K3 ``K3_PER_MINCUT_STEP`` times a
    step and no other kernel; step one's loss and gradients held against
    the CPU; the losses finite."""
    from tgp_tpu_torch import DenseGraphBatch, from_graphs, prepare_batch
    from tgp_tpu_torch.data import GraphLoader

    model = _mincut_model("cuda", alias)
    if alias == "mincut":
        raw = from_graphs(graphs, device="cuda")
    else:
        raw, _ = next(iter(GraphLoader(graphs, labels,
                                       batch_size=len(graphs),
                                       device="cuda")))
    batch = prepare_batch(raw, pooler=model.pooler, normalize=False)
    if isinstance(batch, DenseGraphBatch) != (alias == "mincut"):
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

    # the main path, counted
    reset_counts()
    step_ms, losses, per_step, aux = [], [], [], []
    for i in range(MINCUT_STEPS):
        before = K3.launches
        if i == 0:
            def first():
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
    want["bmm"] = K3_PER_MINCUT_STEP[alias] * MINCUT_STEPS
    if launches != want or per_step != [K3_PER_MINCUT_STEP[alias]] * \
            MINCUT_STEPS:
        raise AssertionError(f"{alias}: {MINCUT_STEPS} steps launched "
                             f"{launches} ({per_step} K3 a step), want "
                             f"{want}")
    if not np.isfinite(losses).all() or not all(
            np.isfinite(a["cut_loss"]) and np.isfinite(a["ortho_loss"])
            for a in aux):
        raise AssertionError(f"{alias}: non-finite losses {losses} {aux}")

    cpu = _mincut_model("cpu", alias)
    cpu.load_state_dict(init)
    cpu_loss, _, cpu_grads = loss_and_grads(cpu, batch.to("cpu"), y.cpu())
    cpu_loss = float(cpu_loss)
    loss_err, grad_err = _step_one_errors(f"{alias}: step one", loss0,
                                          grads0, cpu_loss, cpu_grads)
    med = statistics.median(step_ms)
    result = dict(
        card=card, graphs=len(graphs), k=MINCUT_K, steps=MINCUT_STEPS,
        dense_batch=isinstance(batch, DenseGraphBatch), step_ms=step_ms,
        step_ms_median=med, losses=losses, aux_losses=aux,
        launches=launches, k3_launches_per_step=per_step,
        k3_launches_by_route=k3_routes, step1_loss=loss0,
        step1_cpu_loss=cpu_loss, loss_rel_err=loss_err,
        loss_rel_tol=LOSS_REL_TOL, grad_rel_err=grad_err,
        grad_rel_tol=GRAD_REL_TOL)
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
    print(f"[dense_family] {json.dumps(dict(card=card, rows=rows))}",
          flush=True)
    return rows


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
    mincut = {alias: phase_train_mincut(card, d_graphs, d_labels,
                                        args.profile, alias)
              for alias in ("mincut", "mincut_u")}
    phase_dense_family(card, d_graphs)
    locality = phase_locality(card, d_graphs)
    # the main paths' launches: K1 in sparse training, SAG's serving and
    # training and the clustering poolers'; K2 in the clustering poolers'
    # post-pool GCN and the locality path; K4 (the readout) in all of
    # those, and the clustering poolers' fixed-order sums, ASAP's and
    # PAN's steps; K3 in dense training, LaPool's and MinCut's steps
    k1_runs = (sparse, serving_sag, train_sag, *serving_cl.values(),
               *train_cl.values())
    k2_runs = (*serving_cl.values(), *train_cl.values())
    k4_runs = k1_runs + (small["asap"], small["pan"])
    k3_runs = (train, small["lap"], *mincut.values())

    def entry(name, source, replaces, launches, mode):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=mode["max_abs_err"], ms=mode["ms"],
                    plain_ms=mode["plain_ms"], bound_ms=mode["bound_ms"],
                    bound_by=mode["bound_by"],
                    library_ms=mode["library_ms"])

    loc = locality["launches"]
    kernels = [
        entry("spmm_csr", SOURCE, REPLACES,
              sum(r["launches"]["spmm_csr"] for r in k1_runs),
              modes[f"K1 spmm_csr F={FEATURES} bfloat16"]),
        entry("segment_sum_sorted", SOURCE, K2_REPLACES,
              loc["segment_sum_sorted"]
              + sum(r["launches"]["segment_sum_sorted"] for r in k2_runs),
              modes[f"K2 segment_sum_sorted F={FEATURES} bfloat16"]),
        entry("bmm", K3_SOURCE, K3_REPLACES,
              sum(r["launches"]["bmm"] for r in k3_runs),
              k3_modes["fwd pre"]),
        entry("sorted_segment_sum", K4_SOURCE, K4_REPLACES,
              sum(r["launches"]["sorted_segment_sum"] for r in k4_runs),
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
            *((f"{alias} training", r, f"{MINCUT_STEPS} steps")
              for alias, r in mincut.items()))
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
