"""Host time in ``tgp.model.forward`` (enqueueing the forward's work) a
step, mean over the traced steps."""

from portbench.harness.spans import mean_per_request_ms


def read(ctx):
    return mean_per_request_ms("tgp.model.forward")
