"""DMoN (port of ``tgp_tpu/poolers/dmon.py``; Tsitsulin et al., JMLR
2023): ``spectral_loss`` (modularity), ``cluster_loss`` and
``ortho_loss`` (coefficient 0 by default)."""

from __future__ import annotations

from tgp_tpu_torch.losses import (cluster_loss, orthogonality_loss,
                                  sparse_spectral_loss, spectral_loss,
                                  unbatched_cluster_loss,
                                  unbatched_orthogonality_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["DMoNPooling"]


class DMoNPooling(DenseClusterPooling):
    """``"dmon"``."""

    def __init__(self, *args, spectral_loss_coeff: float = 1.0,
                 cluster_loss_coeff: float = 1.0,
                 ortho_loss_coeff: float = 0.0, **kw):
        super().__init__(*args, **kw)
        self.spectral_loss_coeff = spectral_loss_coeff
        self.cluster_loss_coeff = cluster_loss_coeff
        self.ortho_loss_coeff = ortho_loss_coeff

    def compute_loss(self, dense, so, adj_pool):
        return {
            "spectral_loss": self.spectral_loss_coeff * spectral_loss(
                dense.adj, so.s, adj_pool, mask=dense.mask),
            "cluster_loss": self.cluster_loss_coeff * cluster_loss(
                so.s, mask=dense.mask),
            "ortho_loss": self.ortho_loss_coeff * orthogonality_loss(so.s),
        }

    def compute_sparse_loss(self, batch, so):
        args = (batch.node_graph, batch.num_graphs, batch.node_mask)
        return {
            "spectral_loss": self.spectral_loss_coeff * sparse_spectral_loss(
                batch.senders, batch.receivers, batch.edge_weight, so.s,
                *args),
            "cluster_loss": self.cluster_loss_coeff
            * unbatched_cluster_loss(so.s, *args),
            "ortho_loss": self.ortho_loss_coeff
            * unbatched_orthogonality_loss(so.s, *args),
        }
