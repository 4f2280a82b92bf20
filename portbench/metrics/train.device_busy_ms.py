"""Device time (kernels, copies, sets) per step over the traced window."""

from portbench.harness.readers import train_busy


def read(ctx):
    v = train_busy(ctx)
    return None if v is None else 1e3 * v
