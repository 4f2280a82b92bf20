"""95th percentile latency of all requests completed in the window
(host clock; linear between the two nearest ranks)."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
