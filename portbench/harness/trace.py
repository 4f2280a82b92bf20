"""The device trace of a traced run, and what the per-layer metrics read
from it.

A traced run wraps each traced request or step in a ``portbench.iter``
span (``torch.profiler.record_function``), and a training window's final
synchronize in ``portbench.sync``.  The profiler's trace (CPU and CUDA
activities) is written under ``TMPDIR``, read back and deleted.  Host
and device events of that trace share one clock.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

ITER, SYNC = "portbench.iter", "portbench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the longest gaps that are named by the host op beneath them
NAMED_GAPS = 500


def profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> list:
    """The finished profiler's complete events (``ph == "X"``)."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, a, b) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged
               if s < b and e > a)


def _is_launch(e) -> bool:
    return e.get("cat") in LAUNCH_CATS and "LaunchKernel" in e["name"]


def reduce(evs: list, ops: dict) -> dict:
    """Per traced iteration: span, host time to the first kernel launch,
    device busy time inside the span; over the traced window: busy time,
    kernels launched, device time of each kernel table (``ops``: op name
    to alternatives, each a list of substrings a kernel's name holds
    all of), the ten costliest device operations
    and the longest idle gaps by the host op beneath them.  Times in
    seconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                   if e.get("cat") == "user_annotation" and e["name"] == ITER)
    if not spans:
        return {}
    sync = [e["ts"] + e["dur"] for e in evs
            if e.get("cat") == "user_annotation" and e["name"] == SYNC]
    w0, w1 = spans[0][0], max([spans[-1][1], *sync])
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    merged = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    launches = np.array(sorted(e["ts"] for e in evs if _is_launch(e)))

    iters = []
    for a, b in spans:
        j = np.searchsorted(launches, a)
        first = (float(launches[j]) if j < len(launches)
                 and launches[j] <= b else None)
        iters.append(dict(span_s=(b - a) * 1e-6,
                          busy_s=_overlap(merged, a, b) * 1e-6,
                          prep_s=None if first is None else (first - a) * 1e-6))

    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    op_s = {op: sum(e["dur"] for e in kernels
                    if any(all(k in e["name"] for k in parts)
                           for parts in alts)) * 1e-6
            for op, alts in ops.items()}
    return dict(iters=iters, window_s=(w1 - w0) * 1e-6,
                busy_s=_overlap(merged, w0, w1) * 1e-6,
                kernels=len(kernels), op_device_s=op_s,
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                idle_gaps=_gaps(evs, merged, w0, w1))


def _gaps(evs, merged, w0, w1) -> list:
    """Idle stretches of the window, the longest named by the host op that
    overlaps each most (the innermost on a tie), summed by name."""
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    host = [e for e in evs if e.get("cat") in ("cpu_op", "user_annotation")]
    if not gaps:
        return []
    ts = np.array([e["ts"] for e in host], dtype=np.float64)
    te = ts + np.array([e["dur"] for e in host], dtype=np.float64)
    names = [e["name"] for e in host]
    total = {}
    for a, b in gaps:
        name = "host outside any op"
        if len(ts):
            ov = np.minimum(te, b) - np.maximum(ts, a)
            score = ov - 1e-9 * (te - ts)
            k = int(np.argmax(score))
            if ov[k] > 0:
                name = names[k]
        total[name] = total.get(name, 0.0) + (b - a) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])[:10]
