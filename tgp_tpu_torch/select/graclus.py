"""Graclus selection (port of ``tgp_tpu/select/graclus.py``): greedy
heavy-edge matching — the maximal matching of
:mod:`~tgp_tpu_torch.select.edge_contraction` over edges ranked by weight
(heaviest first, ties by edge order); a matched pair collapses onto its
smaller node id.  ``extras``: the ``rank`` and the matching's ``rounds``.
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.edge_contraction import (contract_matching,
                                                   matching, rank_by)

__all__ = ["graclus_select"]


def graclus_select(batch: GraphBatch, *, weighted: bool = True,
                   s_inv_op: str = "transpose",
                   matching_impl: str = "auto") -> SelectOutput:
    N = batch.num_nodes
    w = (batch.edge_weight if weighted
         else torch.ones_like(batch.edge_weight))
    rank = rank_by(w, batch.edge_mask)
    match, rounds = matching(rank, batch, matching_impl)
    cluster = contract_matching(match, batch.senders, batch.receivers, N,
                                root="min")
    return SelectOutput(
        cluster_index=cluster,
        weight=torch.ones(N, dtype=torch.float32, device=cluster.device),
        node_sel_mask=batch.node_mask, node_graph=batch.node_graph,
        node_mask=batch.node_mask, cluster_graph=batch.node_graph,
        cluster_pos=batch.node_pos, num_clusters=N,
        num_graphs=batch.num_graphs, max_clusters=batch.max_nodes,
        partial=False, s_inv_op=s_inv_op,
        extras={"rank": rank, "match": match, "rounds": rounds})
