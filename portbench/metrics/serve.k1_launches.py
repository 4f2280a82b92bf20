"""K1 (``spmm_csr``) launches inside a request's ``tgp.model.forward``
spans, median over the traced requests."""

from portbench.harness.spans import median_launches


def read(ctx):
    return median_launches("spmm_csr")
