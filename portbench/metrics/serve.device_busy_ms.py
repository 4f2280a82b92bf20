"""Device time (kernels, copies, sets) inside a traced request's span,
mean over the traced requests."""

from portbench.harness.readers import per_iter_mean


def read(ctx):
    v = per_iter_mean(ctx, "busy_s")
    return None if v is None else 1e3 * v
