#!/usr/bin/env python3
"""Time the clustering poolers' served forward and training step (Graclus,
k-MIS, edge contraction) of several checkouts of the port on one card, in
turns.

    python3 scripts/ab_clustering.py LABEL=ROOT [LABEL=ROOT ...]

Each ``ROOT`` is the root of a checkout (this repository, or an unpacked
``git archive`` of another commit).  The checkouts run in turns (the
arguments in order, then in reverse), each in a process of its own with
``ROOT`` first on the path, on ``ROOT/chip_smoke.py``'s served model
(hidden 128, bf16) with that pooler and its first request graph (N =
65,536, E = 1,000,000, F = 128, ``sort_edges=True``): after a warm-up, 10
forwards timed by CUDA events (``forward_ms``, their median), the device
time of 3 forwards from ``torch.profiler`` (``busy_ms_per_forward``),
whether two forwards give the same bits (``repeat_bit_equal``), and for
edge contraction and k-MIS 5 Adam steps on label 1 (``step_ms_median``,
CUDA events), the device time of 3 steps from ``torch.profiler``
(``busy_ms_per_step``) and whether two backward passes of the model in
eval mode give the same gradient bits (``grad_repeat_bit_equal``).  One
JSON line per checkout and pooler, each with the card's name and power
limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ALIASES = ("graclus", "kmis", "ec")


def _events(fn, n):
    import torch

    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def child(label: str, root: str) -> None:
    """One checkout's measurements (run with ``root`` first on the path)."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tgp_tpu_torch import from_graphs
    from tgp_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    card = cs.card_line()
    x, ei = cs.request_graph(7)
    batch = from_graphs([(x, ei)], sort_edges=True, device="cuda")
    y = torch.tensor([1], device="cuda")
    for alias in ALIASES:
        model = cs.build_model("cuda", alias=alias).eval()
        with torch.inference_mode():
            first = model(batch)[0].float().cpu()
            repeat = torch.equal(first, model(batch)[0].float().cpu())
            fwd = _events(lambda: model(batch), 10)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _ in range(3):
                    model(batch)
                torch.cuda.synchronize()
        row = dict(checkout=label, pooler=alias, card=card,
                   forward_ms=statistics.median(fwd), forward_ms_all=fwd,
                   busy_ms_per_forward=_busy_ms(p) / 3,
                   repeat_bit_equal=repeat)
        if alias != "graclus":
            def grads():
                model.zero_grad(set_to_none=True)
                logits, _ = model(batch)
                torch.nn.functional.cross_entropy(logits, y).backward()
                return [q.grad.clone() for q in model.parameters()
                        if q.grad is not None]

            row["grad_repeat_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(grads(), grads()))
            model.train()
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)

            def step():
                opt.zero_grad(set_to_none=True)
                logits, _ = model(batch)
                torch.nn.functional.cross_entropy(logits, y).backward()
                opt.step()

            row["step_ms"] = _events(step, 5)
            row["step_ms_median"] = statistics.median(row["step_ms"])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
            row["busy_ms_per_step"] = _busy_ms(p) / 3
        print(json.dumps(row), flush=True)


def _busy_ms(prof) -> float:
    """Device time (ms) of the kernels a profile recorded."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2])
        return 0
    pairs = [a.split("=", 1) for a in argv]
    if not pairs or any(len(p) != 2 for p in pairs):
        print(__doc__, file=sys.stderr)
        return 2
    for label, root in pairs + pairs[::-1]:
        root = os.path.abspath(root)
        env = {**os.environ, "PYTHONPATH": root}
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", label, root], cwd=root, env=env)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
