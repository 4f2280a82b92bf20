"""k-MIS pooling (port of ``tgp_tpu/poolers/kmis.py``; Bacciu et al.
2023): :class:`~tgp_tpu_torch.select.kmis.KMISSelect`, then a
score-weighted sum over each cluster (``reduce_red_op="sum"``) or only
the MIS members' features scaled by their score (``None``), and a
duplicate-merging connect."""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.kmis import KMISSelect
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["KMISPooling"]


class KMISPooling(SRCPooling):
    """``"kmis"``.  ``in_channels`` builds the linear scorer (JAX infers
    its width); ``score_generator`` (on the pooler's device) feeds the
    ``"random"`` scorer.  The other arguments are
    :class:`~tgp_tpu_torch.select.kmis.KMISSelect`'s and the connect
    flags."""

    IS_TRAINABLE = True
    IS_PRECOARSENABLE = True

    def __init__(self, in_channels: Optional[int] = None, order_k: int = 1,
                 scorer: str = "linear",
                 score_heuristic: Optional[str] = "greedy",
                 force_undirected: bool = False,
                 reduce_red_op: Optional[str] = "sum",
                 s_inv_op: str = "transpose", connect_red_op: str = "sum",
                 remove_self_loops: bool = True, degree_norm: bool = False,
                 edge_weight_norm: bool = False, lift_op: str = "precomputed", lift_red_op: str = "sum", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 score_generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.reduce_red_op = reduce_red_op
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.selector = KMISSelect(
            in_channels, order_k, scorer, score_heuristic, s_inv_op,
            force_undirected=force_undirected, device=resolve_device(device),
            generator=generator, score_generator=score_generator)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = self.selector(batch)
        if self.reduce_red_op is None:
            x_pool = torch.where(so.extras["mis"][:, None],
                                 batch.x * so.weight[:, None], 0.0)
        else:
            x_pool = self.reduce(batch.x, so)
        edges = self.connect(batch, so, self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))
