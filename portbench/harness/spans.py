"""What the per-layer readers take from the program's own spans.

``tgp_tpu_torch.tracing`` records a span at each layer boundary of the
serving and model path while a profiler runs, in a store that holds the
latest profiled stretch: in a ``--trace 1`` run, the traced requests or
steps.  Each request or step is one root span and its children, sharing
a request id.  A program without that module, and a run that profiled
nothing, give None.
"""

from __future__ import annotations

import statistics


def requests():
    """The recorded spans grouped by request id, in order (a list of
    lists of records); None where there are none."""
    try:
        from tgp_tpu_torch import tracing
    except ImportError:
        return None
    groups = {}
    for rec in tracing.spans():
        if rec["end_ns"] is not None:
            groups.setdefault(rec["request"], []).append(rec)
    return list(groups.values()) or None


def ms(rec) -> float:
    return 1e-6 * (rec["end_ns"] - rec["start_ns"])


def median_total_ms(name: str):
    """Median over the requests of the milliseconds spent in spans named
    ``name``; None where no request has one."""
    got = requests()
    if got is None or not any(r["name"] == name for g in got for r in g):
        return None
    return statistics.median(sum(ms(r) for r in g if r["name"] == name)
                             for g in got)


def mean_per_request_ms(name: str):
    """Milliseconds in spans named ``name`` over the requests (or steps)
    that hold one; None where none does."""
    got = [g for g in requests() or [] if any(r["name"] == name for r in g)]
    if not got:
        return None
    return sum(ms(r) for g in got for r in g if r["name"] == name) / len(got)


def attr_share(name: str, part: str, whole: str):
    """100 · Σ attribute ``part`` / Σ attribute ``whole`` over the spans
    named ``name``; None where there are none or the whole is 0."""
    recs = [r for g in requests() or [] for r in g if r["name"] == name
            and whole in r["attrs"]]
    total = sum(r["attrs"][whole] for r in recs)
    if not total:
        return None
    return 100.0 * sum(r["attrs"][part] for r in recs) / total


def median_launches(wrapper: str):
    """Median over the requests of the launches of ``wrapper`` inside their
    ``tgp.model.forward`` spans; None where no request has such a span."""
    got = [[r for r in g if r["name"] == "tgp.model.forward"]
           for g in requests() or []]
    got = [fs for fs in got if fs]
    if not got:
        return None
    return statistics.median(
        sum(f["attrs"].get("launches", {}).get(wrapper, 0) for f in fs)
        for fs in got)
