"""Host time in ``tgp.predict.d2h`` (waiting for the card, then the copy of
the logits back) a request, median over the traced requests."""

from portbench.harness.spans import median_total_ms


def read(ctx):
    return median_total_ms("tgp.predict.d2h")
