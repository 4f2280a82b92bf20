"""The least time of the ``spmm_csr`` operations (kernels/spmm_csr.json) over the
device time of the kernels that carry them, in the traced window."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "spmm_csr")
