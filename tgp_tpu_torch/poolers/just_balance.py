"""JustBalancePool (port of ``tgp_tpu/poolers/just_balance.py``; Bianchi,
NLDL 2023): ``balance_loss = −Tr√(SᵀS)``, and the ``NormalizeAdj``
pre-transform it pairs with (:meth:`JustBalancePooling.data_transforms`)."""

from __future__ import annotations

from tgp_tpu_torch.losses import (just_balance_loss,
                                  unbatched_just_balance_loss)
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling

__all__ = ["JustBalancePooling"]


class JustBalancePooling(DenseClusterPooling):
    """``"jb"``."""

    def __init__(self, *args, normalize_loss: bool = True,
                 loss_coeff: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.normalize_loss = normalize_loss
        self.loss_coeff = loss_coeff

    def compute_loss(self, dense, so, adj_pool):
        return {"balance_loss": self.loss_coeff * just_balance_loss(
            so.s, mask=dense.mask, normalize_loss=self.normalize_loss)}

    def compute_sparse_loss(self, batch, so):
        return {"balance_loss": self.loss_coeff * unbatched_just_balance_loss(
            so.s, batch.node_graph, batch.num_graphs, batch.node_mask,
            normalize_loss=self.normalize_loss)}

    @staticmethod
    def data_transforms():
        from tgp_tpu_torch.data.transforms import NormalizeAdj

        return NormalizeAdj(delta=0.85)
