"""MaxCutPool (port of ``tgp_tpu/poolers/maxcut.py``; Abate & Bianchi,
ICLR 2025): :class:`~tgp_tpu_torch.select.maxcut.MaxCutSelect`, the
sparse reduce, a duplicate-merging connect (always on the total
assignment) and the lift, with the ``maxcut_loss`` ``zᵀAz / vol``."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.losses import maxcut_loss
from tgp_tpu_torch.ops.assignment import assign_all_nodes as _assign_all
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.maxcut import _DEFAULT_MP, MaxCutSelect
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["MaxCutPooling"]


class MaxCutPooling(SRCPooling):
    """``"maxcut"``.  ``assign_all_nodes=False`` keeps the partial top-k
    selection for the reduce (the connect still takes the total
    assignment).  ``mp_impl`` picks the engine of the score net's
    propagation and of the vote (``"auto"``, ``"dense"``, ``"sparse"``).
    ``generator`` draws the score net's weights."""

    IS_TRAINABLE = True
    HAS_LOSS = True

    def __init__(self, in_channels: int = 0, ratio: Union[int, float] = 0.5,
                 loss_coeff: float = 1.0, assign_all_nodes: bool = True,
                 max_iter: int = 5, mp_units: Sequence[int] = _DEFAULT_MP,
                 mp_act: str = "tanh", mlp_units: Sequence[int] = (16, 16),
                 mlp_act: str = "relu", act: str = "tanh",
                 delta: float = 2.0, s_inv_op: str = "transpose",
                 connect_red_op: str = "sum", remove_self_loops: bool = True,
                 degree_norm: bool = False, edge_weight_norm: bool = False,
                 mp_impl: str = "auto", lift_op: str = "precomputed",
                 lift_red_op: str = "sum", *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.loss_coeff = loss_coeff
        self.max_iter = max_iter
        self.mp_impl = mp_impl
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.selector = MaxCutSelect(
            in_channels, ratio, assign_all_nodes, max_iter, mp_units,
            mp_act, mlp_units, mlp_act, act, delta, None, s_inv_op, mp_impl,
            device=resolve_device(device), generator=generator)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = self.selector(batch)
        # a caller's so may carry no scores: the loss is skipped then
        loss = {}
        if "scores" in so.extras:
            loss["maxcut_loss"] = self.loss_coeff * maxcut_loss(
                so.extras["scores"], batch.senders, batch.receivers,
                batch.edge_weight, batch.node_graph, batch.num_graphs)
        x_pool = self.reduce(batch.x, so)
        conn_so = so
        if so.partial:
            conn_so = _assign_all(
                so, batch.senders, batch.receivers, batch.edge_mask,
                max_iter=self.max_iter, node_pos=batch.node_pos,
                max_nodes=batch.max_nodes, impl=self.mp_impl)
        edges = self.connect(batch, conn_so, self.connect_cfg)
        return PoolingOutput(so=so, loss=loss,
                             graph=self.pooled_graph(x_pool, edges, so, batch))
