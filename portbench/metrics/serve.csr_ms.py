"""Host time in ``tgp.collate.csr`` (the receiver sort, ``row_ptr``, the
sender-sorted transpose layout, ``in_degree``) a request, median over the
traced requests; None where no request builds a CSR layout."""

from portbench.harness.spans import median_total_ms


def read(ctx):
    return median_total_ms("tgp.collate.csr")
