"""A step's share of the chip's peak: the least time its work needs over
the traced window's time per step."""

from portbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)
