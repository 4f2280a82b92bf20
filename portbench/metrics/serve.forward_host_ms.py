"""Host time in ``tgp.model.forward`` (enqueueing the forward's work) a
request, median over the traced requests."""

from portbench.harness.spans import median_total_ms


def read(ctx):
    return median_total_ms("tgp.model.forward")
