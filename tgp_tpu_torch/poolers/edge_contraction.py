"""EdgePool / edge-contraction pooling (port of
``tgp_tpu/poolers/edge_contraction.py``; Diehl 2019): the selection of
:class:`~tgp_tpu_torch.select.edge_contraction.EdgeContractionSelect`, a
score-weighted sum reduce, and a connect that merges the duplicate edges
of the contracted pairs.
"""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.edge_contraction import EdgeContractionSelect
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["EdgeContractionPooling"]


class EdgeContractionPooling(SRCPooling):
    """``"ec"``.  ``in_channels`` is the feature width the edge scorer is
    built for (JAX infers it from the features).  ``dropout`` draws from
    ``dropout_generator`` in training mode; the connect flags are
    :class:`~tgp_tpu_torch.connect.base.ConnectConfig`'s."""

    IS_TRAINABLE = True

    def __init__(self, in_channels: int, edge_score_method: str = "softmax",
                 dropout: float = 0.0, add_to_edge_score: float = 0.5,
                 s_inv_op: str = "transpose", connect_red_op: str = "sum",
                 remove_self_loops: bool = True, degree_norm: bool = False,
                 edge_weight_norm: bool = False, lift_op: str = "precomputed", lift_red_op: str = "sum", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.selector = EdgeContractionSelect(
            in_channels, edge_score_method, dropout, add_to_edge_score,
            s_inv_op, device=resolve_device(device),
            generator=generator, dropout_generator=dropout_generator)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = self.selector(batch)
        x_pool = self.reduce(batch.x, so)
        edges = self.connect(batch, so, self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))
