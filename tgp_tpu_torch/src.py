"""SRC(L) core for sparse poolers (port of ``tgp_tpu/src.py``:
``PoolingOutput`` and ``SRCPooling``; the dense base comes with the dense
regime)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from tgp_tpu_torch.connect.base import ConnectConfig, sparse_connect
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.lift.base import base_lift
from tgp_tpu_torch.reduce.base import base_reduce
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["PoolingOutput", "SRCPooling"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class PoolingOutput:
    """Result of one pooling step: the selection, the pooled sparse batch
    and the named auxiliary losses."""

    so: SelectOutput
    graph: Optional[GraphBatch] = None
    loss: Dict[str, Tensor] = field(default_factory=dict)


class SRCPooling(nn.Module):
    """Base class for sparse-world poolers: the shared Reduce / Connect /
    Lift plumbing.  ``lift_op``/``lift_red_op`` configure the lift."""

    def __init__(self, lift_op: str = "precomputed",
                 lift_red_op: str = "sum"):
        super().__init__()
        self.lift_op = lift_op
        self.lift_red_op = lift_red_op

    def reduce(self, x: Tensor, so: SelectOutput) -> Tensor:
        return base_reduce(x, so)

    def lift(self, x_pool: Tensor, so: SelectOutput) -> Tensor:
        return base_lift(x_pool, so, matrix_op=self.lift_op,
                         reduce_op=self.lift_red_op)

    def connect(self, batch: GraphBatch, so: SelectOutput,
                cfg: ConnectConfig = ConnectConfig()):
        return sparse_connect(batch.senders, batch.receivers,
                              batch.edge_weight, batch.edge_mask, so, cfg)

    def pooled_graph(self, x_pool: Tensor, edges, so: SelectOutput,
                     batch: GraphBatch) -> GraphBatch:
        """Assemble the pooled :class:`GraphBatch` from reduce + connect."""
        s, r, w, m = edges
        out_mask = so.out_mask()
        return GraphBatch(
            x=torch.where(out_mask[:, None], x_pool, 0.0),
            senders=s,
            receivers=r,
            edge_weight=w,
            edge_mask=m,
            node_graph=so.cluster_graph,
            node_pos=so.cluster_pos,
            node_mask=out_mask,
            num_graphs=batch.num_graphs,
            max_nodes=so.max_clusters,
        )
