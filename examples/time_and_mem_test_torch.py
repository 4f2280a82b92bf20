"""Per-pooler forward and forward-plus-backward timing, with device memory,
on the PyTorch port ``tgp_tpu_torch`` (the twin of
``examples/time_and_mem_test.py``) over random Erdős–Rényi batches.

    python -m examples.time_and_mem_test_torch                 # on the GPU
    python -m examples.time_and_mem_test_torch topk mincut 50 --device cpu
    python -m examples.time_and_mem_test_torch --profile       # a trace

Times: CUDA events on a card, the host clock on the CPU.  Memory:
``torch.cuda.memory_allocated()`` after the runs (JAX's ``bytes_in_use``)
and the peak since the pooler was built.  An alias that fails prints a
``FAILED`` line and is returned with its error; the caller decides.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.data.loaders import GraphLoader
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.poolers.host_base import HostPooling

POOLERS_TIMED = ["topk", "sag", "asap", "ec", "kmis", "graclus", "maxcut",
                 "mincut", "diff", "dmon", "hosc", "jb", "acc", "lap",
                 "nopool"]


def erdos_renyi_graph(n: int, p: float = 0.3, num_features: int = 4,
                      seed: int = 0):
    """``(x, edge_index)`` of a seeded ER graph, the same arrays as
    ``tests/utils_graphs.py::erdos_renyi_graph``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, num_features)).astype(np.float32)
    upper = rng.random((n, n)) < p
    upper = np.triu(upper, k=1)
    adj = upper | upper.T
    s, r = np.nonzero(adj)
    ei = np.stack([s, r])
    if ei.shape[1] == 0:  # guarantee at least one edge
        ei = np.array([[0], [min(1, n - 1)]])
        ei = np.concatenate([ei, ei[::-1]], axis=1)
    return x, ei


def _timed_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after a warm one."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def make_pooler(alias: str, batch):
    """The timed pooler (``ratio=0.5``, ``k=16``) on ``batch``'s device,
    its weights from a CPU generator seeded 0 (the same on every device),
    its draws from a device generator seeded 1."""
    g = torch.Generator().manual_seed(0)
    sample = torch.Generator(device=batch.x.device).manual_seed(1)
    return get_pooler(alias, in_channels=batch.num_features, ratio=0.5,
                      k=16, device=batch.x.device, generator=g,
                      sample_generator=sample)


def pooled_value(pooler, batch) -> torch.Tensor:
    """The timed forward: ``Σ x_pool² + the pooler's losses``."""
    out = pooler(batch)
    x = out.graph.x if out.graph is not None else out.dense.x
    return (x.float() ** 2).sum() + out.loss_sum()


def bench_pooler(alias: str, batch, iters: int = 10) -> dict:
    """``{pooler, fwd_ms, fwd_bwd_ms, device_mem_mb, peak_mem_mb}`` of one
    alias on ``batch``: :func:`pooled_value` and its gradient with respect
    to the pooler's parameters (as JAX's ``jax.grad(fwd)``; a pooler
    without trainable parameters has JAX's empty gradient tree, so only
    its forward runs).  A host pooler's forward alone is timed."""
    device = batch.x.device
    pooler = make_pooler(alias, batch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def fwd():
        return pooled_value(pooler, batch)

    if isinstance(pooler, HostPooling):
        with torch.no_grad():
            return dict(pooler=alias, fwd_ms=_timed_ms(fwd, iters, device),
                        fwd_bwd_ms=float("nan"), device_mem_mb=None,
                        peak_mem_mb=None)
    params = [p for p in pooler.parameters() if p.requires_grad]

    def fwd_bwd():
        loss = fwd()
        if not params:  # the gradient of an empty tree
            return loss.new_zeros(())
        grads = torch.autograd.grad(loss, params)
        return sum((gr.float() ** 2).sum() for gr in grads)

    with torch.no_grad():
        fwd_ms = _timed_ms(fwd, iters, device)
    fwd_bwd_ms = _timed_ms(fwd_bwd, iters, device)
    mem = peak = None
    if device.type == "cuda":
        mem = torch.cuda.memory_allocated(device) / 2 ** 20
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    return dict(pooler=alias, fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                device_mem_mb=mem, peak_mem_mb=peak)


def main(sizes=(50, 200), batch_size=4, num_features=16,
         profile_dir: Optional[str] = None, poolers=None, device="cuda",
         iters: int = 10):
    """Time every alias of ``poolers`` (default :data:`POOLERS_TIMED`) at
    each size; returns one result dict per (size, alias), with ``n`` and
    ``edges``, and ``error`` for an alias that failed.  ``profile_dir``
    writes a ``torch.profiler`` trace (``trace.json``) there."""
    device = resolve_device(device)
    prof = None
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    results = []
    for n in sizes:
        graphs = [erdos_renyi_graph(n, p=min(8.0 / n, 0.5),
                                    num_features=num_features, seed=i)
                  for i in range(batch_size)]
        batch = next(iter(GraphLoader(graphs, batch_size=batch_size,
                                      device=device)))
        edges = int(batch.edge_mask.sum())
        print(f"== N={n} x {batch_size} graphs (E={edges}) ==", flush=True)
        for alias in poolers or POOLERS_TIMED:
            try:
                r = bench_pooler(alias, batch, iters)
                mem = (f" mem={r['device_mem_mb']:.0f}MB peak="
                       f"{r['peak_mem_mb']:.0f}MB"
                       if r["device_mem_mb"] is not None else "")
                print(f"  {alias:10s} fwd {r['fwd_ms']:8.2f}ms  "
                      f"fwd+bwd {r['fwd_bwd_ms']:8.2f}ms{mem}", flush=True)
            except Exception as exc:  # noqa: BLE001 — returned to the caller
                r = dict(pooler=alias, error=f"{type(exc).__name__}: {exc}")
                print(f"  {alias:10s} FAILED: {r['error']}", flush=True)
            results.append(dict(r, n=n, edges=edges))
    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"profiler trace written to {profile_dir}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("args", nargs="*", help="aliases and sizes")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    aliases = [v for v in a.args if not v.isdigit()] or None
    sizes = tuple(int(v) for v in a.args if v.isdigit()) or (50, 200)
    out = main(sizes, profile_dir="tgp_profile" if a.profile else None,
               poolers=aliases, device=a.device)
    raise SystemExit(1 if any("error" in r for r in out) else 0)
