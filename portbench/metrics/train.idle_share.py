"""1 − device busy / wall over the traced steps' window."""

from portbench.harness.readers import train_idle


def read(ctx):
    return train_idle(ctx)
