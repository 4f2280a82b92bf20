"""AsymCheegerCutPool (port of ``tgp_tpu/poolers/asym_cheeger_cut.py``;
Hansen & Bianchi, ICML 2023): ``total_variation_loss`` and the
asymmetric-norm ``balance_loss``."""

from __future__ import annotations

from tgp_tpu_torch.losses import (asym_norm_loss, sparse_totvar_loss,
                                  totvar_loss, unbatched_asym_norm_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["AsymCheegerCutPooling"]


class AsymCheegerCutPooling(DenseClusterPooling):
    """``"acc"``."""

    def __init__(self, *args, totvar_coeff: float = 1.0,
                 balance_coeff: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.totvar_coeff = totvar_coeff
        self.balance_coeff = balance_coeff

    def compute_loss(self, dense, so, adj_pool):
        return {
            "total_variation_loss": self.totvar_coeff * totvar_loss(
                so.s, dense.adj),
            "balance_loss": self.balance_coeff * asym_norm_loss(
                so.s, self.k, mask=dense.mask),
        }

    def compute_sparse_loss(self, batch, so):
        return {
            "total_variation_loss": self.totvar_coeff * sparse_totvar_loss(
                batch.senders, batch.receivers, batch.edge_weight, so.s,
                batch.node_graph, batch.num_graphs),
            "balance_loss": self.balance_coeff * unbatched_asym_norm_loss(
                so.s, self.k, batch.node_graph, batch.num_graphs,
                batch.node_mask),
        }
