"""Host time from a request's start to the launch of its first CUDA
kernel (copies not counted): collation, layout and the copy to the card.
Median over the traced requests."""

import statistics


def read(ctx):
    got = [it["prep_s"] for it in ctx.get("trace", {}).get("iters", [])
           if it["prep_s"] is not None]
    return 1e3 * statistics.median(got) if got else None
