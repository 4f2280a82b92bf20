"""Graclus pooling (port of ``tgp_tpu/poolers/graclus.py``; Dhillon et al.
2007): heavy-edge matching (:func:`~tgp_tpu_torch.select.graclus.
graclus_select`), a sum reduce and a duplicate-merging connect; no
parameters."""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.graclus import graclus_select
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["GraclusPooling"]


class GraclusPooling(SRCPooling):
    """``"graclus"``.  ``weighted=False`` ranks every edge alike (edge
    order).  ``reduce_red_op`` is accepted and not read, as in JAX, whose
    pooler has the field and always sums."""

    IS_PRECOARSENABLE = True

    def __init__(self, weighted: bool = True, reduce_red_op: str = "sum",
                 s_inv_op: str = "transpose",
                 connect_red_op: str = "sum", remove_self_loops: bool = True,
                 degree_norm: bool = False, edge_weight_norm: bool = False,
                 lift_op: str = "precomputed", lift_red_op: str = "sum"):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.weighted = weighted
        self.reduce_red_op = reduce_red_op
        self.s_inv_op = s_inv_op
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = graclus_select(batch, weighted=self.weighted,
                                s_inv_op=self.s_inv_op)
        x_pool = self.reduce(batch.x, so)
        edges = self.connect(batch, so, self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))
