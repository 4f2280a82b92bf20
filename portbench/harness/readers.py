"""Arithmetic the per-layer readers share.  Each takes the run's context
(``trace``: :func:`portbench.harness.trace.reduce`'s output; ``work``:
one count of operations and bytes per traced iteration) and returns
None where there is nothing to read."""

from __future__ import annotations

from portbench.harness import counting


def _red(ctx):
    red = ctx.get("trace") or {}
    return red if red.get("iters") else None


def per_iter_mean(ctx, key: str):
    red = _red(ctx)
    if red is None:
        return None
    return sum(it[key] for it in red["iters"]) / len(red["iters"])


def serve_idle(ctx):
    red = _red(ctx)
    if red is None:
        return None
    span = sum(it["span_s"] for it in red["iters"])
    busy = sum(it["busy_s"] for it in red["iters"])
    return 100.0 * (1.0 - busy / span) if span > 0 else None


def train_busy(ctx):
    red = _red(ctx)
    return None if red is None else red["busy_s"] / len(red["iters"])


def train_idle(ctx):
    red = _red(ctx)
    if red is None or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def _wall(ctx, red) -> float:
    """The traced iterations' time: their own spans when serving (a
    request ends in a copy to the host), the traced window's when
    training (steps run ahead of the card)."""
    if ctx["loop"] == "serve":
        return sum(it["span_s"] for it in red["iters"])
    return red["window_s"]


def mfu(ctx):
    """Whole request's or step's share of the peak, in %."""
    red = _red(ctx)
    if red is None or not ctx.get("work"):
        return None
    peaks = ctx["peaks"]
    least = sum(counting.least_seconds(w["flops"], w["bytes"],
                                       peaks["bf16_tensor_flops"], peaks)
                for w in ctx["work"][:len(red["iters"])])
    wall = _wall(ctx, red)
    return 100.0 * least / wall if wall > 0 else None


def roofline(ctx, op: str):
    """The ``op`` operations' least time over their kernels' device time,
    in %; None where no such kernel ran."""
    red = _red(ctx)
    if red is None:
        return None
    measured = red["op_device_s"].get(op, 0.0)
    least = sum(counting.op_seconds(o, ctx["peaks"])
                for w in ctx["work"][:len(red["iters"])]
                for o in w["ops"] if o["name"] == op)
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
