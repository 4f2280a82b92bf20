"""NoPool, identity pooling (port of ``tgp_tpu/poolers/nopool.py``): a
baseline that keeps the pipeline's shape — every node its own supernode,
the batch passed through unchanged (its CSR layout included)."""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["NoPool", "identity_select"]


def identity_select(batch: GraphBatch) -> SelectOutput:
    """Each node maps to itself (partial: no duplicate edges to merge)."""
    N = batch.num_nodes
    return SelectOutput(
        cluster_index=torch.arange(N, dtype=torch.int32, device=batch.device),
        weight=torch.ones(N, dtype=torch.float32, device=batch.device),
        node_sel_mask=batch.node_mask, node_graph=batch.node_graph,
        node_mask=batch.node_mask, cluster_graph=batch.node_graph,
        cluster_pos=batch.node_pos, num_clusters=N,
        num_graphs=batch.num_graphs, max_clusters=batch.max_nodes,
        partial=True)


class NoPool(SRCPooling):
    """``"nopool"``."""

    IS_PRECOARSENABLE = True

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = identity_select(batch)
        return PoolingOutput(so=so, graph=batch)
