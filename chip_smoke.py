#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tgp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with one CUDA card; it builds
the CUDA kernels from ``tgp_tpu_torch/csrc`` into ``build/`` first.  Phases,
each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels (one ``nvcc`` per source, all at once);
3. every kernel against its plain PyTorch version at the serving path's
   shapes, with times: the kernel, the plain version, the least time the
   card could take (bytes over 3.35 TB/s or flops over 67 TFLOP/s, the
   larger), and one PyTorch library call computing the same function;
4. serving: ``Predictor`` over ``PoolingClassifier`` (GCN → top-k → GCN →
   sum readout → MLP head, hidden 128, bf16) on full-size requests (one
   graph each: 65,536 nodes, 1,000,000 random edges, 128 features), with
   the kernels' launch counts, and the logits held against the same model
   run on the CPU with the kernels' plain versions.

The next-to-last line of output is a JSON object ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the rest of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
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
REPEATS = 20
REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:224"  # _grouped_kernel_w
K2_REPLACES = "tgp_tpu/ops/pallas/segment_spmm.py:205"  # _grouped_kernel
SOURCE = "tgp_tpu_torch/csrc/segment_spmm.cu"


def request_graph(seed: int):
    """One request as ``bench.py``'s large-graph leg makes it."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N_NODES, N_EDGES)
    r = rng.integers(0, N_NODES, N_EDGES)
    x = rng.normal(size=(N_NODES, FEATURES)).astype(np.float32)
    return x, np.stack([s, r])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over REPEATS launches, each after an
    L2 flush (the serving path finds the edge arrays cold)."""
    fn()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_mode(name, kernel, plain, library, *, rel_tol, bound_bytes, flops,
               scale, flush):
    """Hold one kernel mode against its plain version, then time all
    three.  Tolerance: |kernel − plain| ≤ rel_tol · (row's Σ|w·x|)."""
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (got.float() - ref.float()).abs()
    max_abs = float(err.max())
    worst = float((err / (scale + 1e-30)).max())
    if not (torch.isfinite(got.float()).all() and worst <= rel_tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |err| {max_abs}, max err/scale "
                             f"{worst} > {rel_tol}")
    row = dict(mode=name, max_abs_err=max_abs, max_rel_err=worst,
               rel_tol=rel_tol, ms=median_ms(kernel, flush),
               plain_ms=median_ms(plain, flush),
               bound_ms=1e3 * max(bound_bytes / HBM_BYTES_PER_S,
                                  flops / FP32_FLOPS_PER_S),
               bound_by=("bytes" if bound_bytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
               library_ms=median_ms(library, flush))
    print(f"[kernels] {json.dumps(row)}", flush=True)
    return row


def phase_kernels(batch):
    """Each kernel mode the serving path runs (and the K2 mode) at its
    shapes, on the collated request's own CSR arrays."""
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
        name = f"K1 spmm_csr F={F} {str(dtype).split('.')[-1]}"
        modes[name] = check_mode(
            name, lambda: K.spmm_csr(x, weights, idx, row_ptr, N),
            lambda: K.spmm_csr_plain(x, weights, idx, row_ptr, N),
            sparse_mm(weights, idx, x),
            rel_tol=1e-2 if dtype == torch.bfloat16 else 1e-4,
            bound_bytes=csr_bytes + 2 * N * F * isz, flops=2 * E * F,
            scale=scale, flush=flush)

    # K2 mode: receiver-sorted messages [E, F], no gather, no weight
    msgs = (torch.randn(E, FEATURES, generator=gen, device="cuda")
            * w[:, None]).to(torch.bfloat16)
    rec = batch.receivers
    scale = K.segment_sum_sorted_plain(msgs.float().abs(), rec, N, row_ptr)
    ones = torch.ones(E, device="cuda")
    cols = torch.arange(E, dtype=torch.int32, device="cuda")
    name = "K2 segment_sum_sorted F=128 bfloat16"
    modes[name] = check_mode(
        name, lambda: K.segment_sum_sorted(msgs, rec, N, row_ptr),
        lambda: K.segment_sum_sorted_plain(msgs, rec, N, row_ptr),
        sparse_mm(ones, cols, msgs), rel_tol=1e-2,
        bound_bytes=4 * (rows + 1) + 2 * E * FEATURES + 2 * N * FEATURES,
        flops=E * FEATURES, scale=scale, flush=flush)
    del flush
    return modes


def build_model(device, *, pool_mode="auto", use_kernel=None):
    """The served model, its weights drawn from one seeded generator."""
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    g = torch.Generator().manual_seed(0)
    pooler = get_pooler("topk", in_channels=HIDDEN, ratio=0.5,
                        pool_mode=pool_mode, device=device, generator=g)
    return PoolingClassifier(pooler, num_classes=CLASSES, hidden=HIDDEN,
                             compute_dtype=torch.bfloat16,
                             use_kernel=use_kernel, device=device,
                             generator=g)


def phase_serving(card, graphs, batch, collate_ms, profile: bool):
    """Serve ``graphs`` (``batch`` is the first, collated) with the
    defaults a user gets, count the kernel launches, and hold the logits
    to the CPU."""
    from tgp_tpu_torch import Predictor
    from tgp_tpu_torch.ops.kernels import segment_spmm as K

    model = build_model("cuda").eval()
    predictor = Predictor(lambda b: model(b)[0], batch_size=1,
                          sort_edges=True, device="cuda")
    with torch.inference_mode():
        logits, out = model(batch)  # warm-up: cuBLAS handles, allocator
    if out.so.extras.get("pool_mode") != "masked":
        raise AssertionError("the served request did not take masked pooling")

    # the main path, counted: the predictor answers every request
    K.spmm_csr.launches = 0
    K.segment_sum_sorted.launches = 0
    req_ms, served = [], []
    for g in graphs:
        t0 = time.perf_counter()
        served.append(predictor([g]))
        req_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"spmm_csr": K.spmm_csr.launches,
                "segment_sum_sorted": K.segment_sum_sorted.launches}
    if launches["spmm_csr"] != 3 * REQUESTS:
        raise AssertionError(f"spmm_csr launched {launches['spmm_csr']} "
                             f"times for {REQUESTS} requests, want 3 each")
    served = np.concatenate(served)
    if served.shape != (REQUESTS, CLASSES) or not np.isfinite(served).all():
        raise AssertionError(f"bad logits {served}")

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

    # the same model and request on the CPU, kernels' plain versions
    cpu_model = build_model("cpu", pool_mode="masked", use_kernel=True)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.inference_mode():
        ref, ref_out = cpu_model(batch.to("cpu"))
    ref = ref.numpy()
    tol = 2e-2 * float(np.abs(ref).max())
    diff = float(np.abs(served[0] - ref[0]).max())
    if ref_out.so.extras.get("pool_mode") != "masked" or diff > tol:
        raise AssertionError(f"GPU logits {served[0]} vs CPU {ref[0]}: "
                             f"max |diff| {diff} > {tol}")

    result = dict(
        card=card, requests=REQUESTS, request_ms=req_ms,
        request_ms_median=statistics.median(req_ms),
        edges_per_s=N_EDGES / (statistics.median(req_ms) / 1e3),
        collate_ms=collate_ms, forward_device_ms=statistics.median(fwd),
        forward_device_ms_all=fwd, launches=launches,
        logits_first=served[0].tolist(), cpu_logits_first=ref[0].tolist(),
        max_abs_diff_vs_cpu=diff, tol=tol)
    print(f"[serving] {json.dumps(result)}", flush=True)

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with torch.inference_mode(), prof(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                model(batch)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=25), flush=True)
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
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)}",
          flush=True)
    for name, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {secs:.2f} s; " + " | ".join(regs),
              flush=True)

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
    serving = phase_serving(card, graphs, batch, collate_ms, args.profile)

    main_mode = modes[f"K1 spmm_csr F={FEATURES} bfloat16"]
    kernels = [dict(
        name="spmm_csr", route="cuda", source=SOURCE, replaces=REPLACES,
        launches=serving["launches"]["spmm_csr"],
        max_abs_err=main_mode["max_abs_err"], ms=main_mode["ms"],
        plain_ms=main_mode["plain_ms"], bound_ms=main_mode["bound_ms"],
        bound_by=main_mode["bound_by"], library_ms=main_mode["library_ms"])]
    print(f"[modes] {json.dumps(list(modes.values()))}", flush=True)
    print(f"K2 mode ({K2_REPLACES}) shares {SOURCE}; the serving path "
          f"launched it {serving['launches']['segment_sum_sorted']} times",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
