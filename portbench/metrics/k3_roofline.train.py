"""The least time of the ``dense_bmm`` operations (kernels/dense_bmm.json) over the
device time of the kernels that carry them, in the traced window."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "dense_bmm")
