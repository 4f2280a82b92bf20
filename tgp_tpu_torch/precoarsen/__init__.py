"""Precoarsening (port of ``tgp_tpu/precoarsen``): selections that depend
on the graph alone run once, on the host, before training — NDP's spectral
split and Kron reduction, Graclus matching, SEP coding trees, NMF and
EigenPool's spectral clustering — as per-graph numpy level functions
whose level dicts :class:`PreCoarsening` attaches to each graph and
:mod:`tgp_tpu_torch.data.pooled_loader` collates into device batches; only
reduce and message passing run in the training step.
"""

from tgp_tpu_torch.precoarsen.api import (
    PRECOARSENERS,
    PreCoarsening,
    precoarsen_graph,
    register_precoarsener,
)

__all__ = [
    "PRECOARSENERS",
    "PreCoarsening",
    "precoarsen_graph",
    "register_precoarsener",
]
