"""A request's share of the chip's peak: the least time its work needs
(the larger of its operations over the bf16 peak and its compulsory
bytes over HBM's rate) over its measured time in the traced window."""

from portbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)
