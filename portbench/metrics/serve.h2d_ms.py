"""Host time in ``tgp.collate.h2d`` (the copies of the collated arrays to
the card) a request, median over the traced requests."""

from portbench.harness.spans import median_total_ms


def read(ctx):
    return median_total_ms("tgp.collate.h2d")
