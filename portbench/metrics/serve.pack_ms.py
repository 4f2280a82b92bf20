"""Host time in ``tgp.collate.pack`` (checks, the copy into padded numpy
arrays, self-loop marks) a request, median over the traced requests."""

from portbench.harness.spans import median_total_ms


def read(ctx):
    return median_total_ms("tgp.collate.pack")
