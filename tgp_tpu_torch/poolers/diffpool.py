"""DiffPool (port of ``tgp_tpu/poolers/diffpool.py``; Ying et al.,
NeurIPS 2018): ``link_loss`` (``‖A−SSᵀ‖_F``) and ``entropy_loss``."""

from __future__ import annotations

from tgp_tpu_torch.losses import (entropy_loss, link_pred_loss,
                                  sparse_link_pred_loss,
                                  unbatched_entropy_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["DiffPool"]


class DiffPool(DenseClusterPooling):
    """``"diff"``."""

    def __init__(self, *args, link_loss_coeff: float = 1.0,
                 ent_loss_coeff: float = 1.0, normalize_loss: bool = False,
                 **kw):
        super().__init__(*args, **kw)
        self.link_loss_coeff = link_loss_coeff
        self.ent_loss_coeff = ent_loss_coeff
        self.normalize_loss = normalize_loss

    def compute_loss(self, dense, so, adj_pool):
        return {
            "link_loss": self.link_loss_coeff * link_pred_loss(
                so.s, dense.adj, normalize_loss=self.normalize_loss,
                mask=dense.mask),
            # normalized by the valid node count
            "entropy_loss": self.ent_loss_coeff * entropy_loss(
                so.s, mask=dense.mask),
        }

    def compute_sparse_loss(self, batch, so):
        return {
            "link_loss": self.link_loss_coeff * sparse_link_pred_loss(
                so.s, batch.senders, batch.receivers, batch.edge_weight,
                batch.node_graph, batch.num_graphs, batch.node_mask,
                normalize_loss=self.normalize_loss),
            "entropy_loss": self.ent_loss_coeff * unbatched_entropy_loss(
                so.s, node_mask=batch.node_mask),
        }
