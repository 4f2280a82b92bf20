"""HOSCPool (port of ``tgp_tpu/poolers/hosc.py``; Duval & Malliaros,
CIKM 2022): first- and higher-order mincut over the motif adjacency
``A³``, mixed by ``alpha``, and an orthogonality term weighted by
``mu``."""

from __future__ import annotations

import torch

from tgp_tpu_torch.losses import (hosc_orthogonality_loss, mincut_loss,
                                  orthogonality_loss, sparse_ho_mincut_loss,
                                  sparse_mincut_loss,
                                  unbatched_hosc_orthogonality_loss,
                                  unbatched_orthogonality_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["HOSCPooling"]


class HOSCPooling(DenseClusterPooling):
    """``"hosc"``."""

    def __init__(self, *args, mu: float = 0.1, alpha: float = 0.5,
                 hosc_ortho: bool = False, **kw):
        super().__init__(*args, **kw)
        self.mu = mu
        self.alpha = alpha
        self.hosc_ortho = hosc_ortho

    def _mix(self, cut, ho_cut, ortho):
        hosc = (1 - self.alpha) * cut + self.alpha * ho_cut
        return {"hosc_loss": hosc, "ortho_loss": self.mu * ortho}

    def compute_loss(self, dense, so, adj_pool):
        s, adj = so.s, dense.adj
        cut = ho_cut = ortho = s.new_zeros(())
        if self.alpha < 1:
            cut = mincut_loss(adj, s, adj_pool) / self.k
        if self.alpha > 0:
            motif = torch.matmul(torch.matmul(adj, adj), adj)
            motif_pool = torch.matmul(s.transpose(1, 2),
                                      torch.matmul(motif, s))
            ho_cut = mincut_loss(motif, s, motif_pool) / self.k
        if self.mu != 0:
            ortho = (hosc_orthogonality_loss(s, mask=dense.mask)
                     if self.hosc_ortho else orthogonality_loss(s))
        return self._mix(cut, ho_cut, ortho)

    def compute_sparse_loss(self, batch, so):
        s = so.s
        args = (batch.senders, batch.receivers, batch.edge_weight, s,
                batch.node_graph, batch.num_graphs, batch.node_mask)
        cut = ho_cut = ortho = s.new_zeros(())
        if self.alpha < 1:
            cut = sparse_mincut_loss(*args) / self.k
        if self.alpha > 0:
            ho_cut = sparse_ho_mincut_loss(*args) / self.k
        if self.mu != 0:
            per_graph = (batch.node_graph, batch.num_graphs, batch.node_mask)
            ortho = (unbatched_hosc_orthogonality_loss(s, *per_graph)
                     if self.hosc_ortho
                     else unbatched_orthogonality_loss(s, *per_graph))
        return self._mix(cut, ho_cut, ortho)
