"""Median latency of all requests completed in the window (host clock,
from the call of ``Predictor.__call__`` to its return, which ends in a
device-to-host copy)."""

import statistics


def read(ctx):
    lat = ctx.get("latencies_s")
    return 1e3 * statistics.median(lat) if lat else None
