"""Host-side pooler base for the precoarsenable poolers without parameters
(port of ``tgp_tpu/poolers/host_base.py``): NDP, NMF, SEP and EigenPool
select on the host through their numpy level functions, one graph at a
time, then reduce on the batch's device.

A call reads the batch back to the host once, runs the level function on
each graph, collates the levels on the batch's device
(:func:`~tgp_tpu_torch.data.pooled_loader.collate_level`) and reduces.
For training, :class:`~tgp_tpu_torch.precoarsen.PreCoarsening` runs the
selection once, offline; these poolers serve ``get_pooler`` and eager
use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from tgp_tpu_torch.data.pooled_loader import collate_level
from tgp_tpu_torch.graph import GraphBatch, ceil_to
from tgp_tpu_torch.lift.base import base_lift
from tgp_tpu_torch.reduce.base import base_reduce
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.src import PoolingOutput

__all__ = ["HostPooling"]


class HostPooling(nn.Module):
    """Eager pooler driven by a per-graph level function
    (:meth:`level_fn` with :meth:`level_kwargs`).  Its capability flags
    are JAX's: no ``SUPPORTS_SPARSE_OUT`` or ``ACCEPTS_DENSE_BATCH``."""

    IS_DENSE = False
    HAS_LOSS = False
    IS_TRAINABLE = False
    IS_PRECOARSENABLE = True

    def level_fn(self) -> Callable:
        raise NotImplementedError

    def level_kwargs(self) -> Dict[str, Any]:
        return {}

    def _per_graph_levels(self, batch: GraphBatch):
        """Each graph's level dict, from one host read of the batch's
        edges and node layout; also each graph's node count."""
        E, N = batch.num_edges, batch.num_nodes
        packed = torch.cat([
            batch.senders.to(torch.int32), batch.receivers.to(torch.int32),
            batch.edge_weight.to(torch.float32).view(torch.int32),
            batch.edge_mask.to(torch.int32), batch.node_graph.to(torch.int32),
            batch.node_mask.to(torch.int32)]).cpu().numpy()
        s, r = packed[:E], packed[E:2 * E]
        w = packed[2 * E:3 * E].view(np.float32)
        em = packed[3 * E:4 * E].astype(bool)
        ng = packed[4 * E:4 * E + N]
        nm = packed[4 * E + N:].astype(bool)
        counts = np.bincount(ng[nm], minlength=batch.num_graphs)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        fn, kw = self.level_fn(), self.level_kwargs()
        out = []
        for g in range(batch.num_graphs):
            n, o = int(counts[g]), int(starts[g])
            e_sel = em & (ng[s] == g)
            out.append(fn(np.stack([s[e_sel] - o, r[e_sel] - o]), n,
                          w[e_sel], **kw))
        return out, starts

    def reduce_level(self, x: torch.Tensor, so: SelectOutput) -> torch.Tensor:
        return base_reduce(x, so)

    def lift_level(self, x_pool: torch.Tensor,
                   so: SelectOutput) -> torch.Tensor:
        return base_lift(x_pool, so)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift_level(x if x is not None else batch.x, so)
        levels, starts = self._per_graph_levels(batch)
        k_tot = sum(int(lv["num_clusters"]) for lv in levels)
        e_tot = sum(int(np.asarray(lv["edge_index"]).shape[1])
                    for lv in levels)
        kmax = max(int(lv["num_clusters"]) for lv in levels)
        lb = collate_level(levels, starts, batch.num_nodes,
                           ceil_to(max(k_tot, 1), 8),
                           ceil_to(max(e_tot, 1), 128), kmax,
                           feature_dim=batch.num_features,
                           prev_max_nodes=batch.max_nodes,
                           device=batch.device)
        x_pool = self.reduce_level(batch.x, lb.so)
        return PoolingOutput(
            so=lb.so, graph=lb.graph.replace(x=lb.place_features(x_pool)))
