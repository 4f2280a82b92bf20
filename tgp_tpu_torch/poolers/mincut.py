"""MinCutPool (port of ``tgp_tpu/poolers/mincut.py``; Bianchi et al.,
ICML 2020): ``cut_loss`` and ``ortho_loss``."""

from __future__ import annotations

from tgp_tpu_torch.losses import (mincut_loss, orthogonality_loss,
                                  sparse_mincut_loss,
                                  unbatched_orthogonality_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["MinCutPooling"]


class MinCutPooling(DenseClusterPooling):
    """``"mincut"``."""

    def __init__(self, *args, cut_loss_coeff: float = 1.0,
                 ortho_loss_coeff: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.cut_loss_coeff = cut_loss_coeff
        self.ortho_loss_coeff = ortho_loss_coeff

    def compute_loss(self, dense, so, adj_pool):
        return {
            "cut_loss": self.cut_loss_coeff
            * mincut_loss(dense.adj, so.s, adj_pool),
            "ortho_loss": self.ortho_loss_coeff * orthogonality_loss(so.s),
        }

    def compute_sparse_loss(self, batch, so):
        return {
            "cut_loss": self.cut_loss_coeff * sparse_mincut_loss(
                batch.senders, batch.receivers, batch.edge_weight, so.s,
                batch.node_graph, batch.num_graphs, batch.node_mask),
            "ortho_loss": self.ortho_loss_coeff
            * unbatched_orthogonality_loss(
                so.s, batch.node_graph, batch.num_graphs, batch.node_mask),
        }
