"""Top-k pooling on a sparse batch (port of the sparse branch of
``tgp_tpu/poolers/topk.py``): TopkSelect → reduce → sparse connect → lift,
or the masked in-place layout (:mod:`tgp_tpu_torch.poolers._masked`)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.poolers._masked import (masked_lift, masked_pool,
                                           use_masked_pool)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import TopkSelect
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["TopkPooling"]


class TopkPooling(SRCPooling):
    """Top-k pooling.  Pooled features are the kept nodes' features scaled
    by their score times ``multiplier``; the pooled adjacency is the
    kept-node subgraph.

    ``pool_mode``: ``"compact"`` relabels kept nodes into the ``[B·Kmax]``
    supernode space; ``"masked"`` keeps the original node space (gated
    features, shrunk ``node_mask``); ``"auto"`` takes masked where the
    post-pool conv runs the CSR kernel (:func:`~tgp_tpu_torch.poolers.
    _masked.use_masked_pool`), compact otherwise."""

    def __init__(self, in_channels: Optional[int] = None,
                 ratio: Union[int, float] = 0.5,
                 min_score: Optional[float] = None,
                 act: Union[str, Callable, None] = "tanh",
                 multiplier: float = 1.0, s_inv_op: str = "transpose",
                 connect_red_op: str = "sum", remove_self_loops: bool = True,
                 degree_norm: bool = False, edge_weight_norm: bool = False,
                 pool_mode: str = "auto", lift_op: str = "precomputed",
                 lift_red_op: str = "sum", *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.in_channels = in_channels
        self.ratio = ratio
        self.multiplier = multiplier
        self.s_inv_op = s_inv_op
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.pool_mode = pool_mode
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.selector = TopkSelect(in_channels, ratio, min_score, act,
                                   s_inv_op, device=resolve_device(device),
                                   generator=generator)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = self.selector(batch)
        if use_masked_pool(self.pool_mode, batch,
                           degree_norm=self.degree_norm,
                           edge_weight_norm=self.edge_weight_norm,
                           s_inv_op=self.s_inv_op):
            return masked_pool(batch, so, multiplier=self.multiplier,
                               remove_self_loops=self.remove_self_loops)
        x_pool = self.reduce(batch.x, so) * self.multiplier
        edges = self.connect(batch, so, self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))

    def lift(self, x_pool: torch.Tensor, so: SelectOutput) -> torch.Tensor:
        if so.extras.get("pool_mode") == "masked":
            return masked_lift(x_pool, so, self.s_inv_op)
        return super().lift(x_pool, so)
