"""Host time in ``tgp.model.pool`` (the poolers' scoring, ranking and
pooling, every level) a step, mean over the traced steps."""

from portbench.harness.spans import mean_per_request_ms


def read(ctx):
    return mean_per_request_ms("tgp.model.pool")
