"""Top-k selection on a sparse batch (port of the sparse parts of
``tgp_tpu/select/topk.py``).

Scores are ranked within each graph (:func:`~tgp_tpu_torch.ops.segment.
segment_topk_rank`); node *i* is kept iff ``rank < ceil(ratio · n_g)`` and
becomes supernode ``g_i · Kmax + rank_i`` in a graph-major static id space
of ``B · Kmax`` slots (``Kmax = ceil(ratio · max_nodes)``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import (segment_max, segment_softmax,
                                       segment_topk_rank)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["topk_budget", "topk_select_from_scores", "TopkSelect"]

Tensor = torch.Tensor


def topk_budget(ratio: Union[int, float], max_nodes: int) -> int:
    """Static per-graph supernode budget ``Kmax``."""
    if isinstance(ratio, int) and ratio >= 1:
        return min(ratio, max_nodes)
    return max(int(math.ceil(ratio * max_nodes)), 1)


def topk_select_from_scores(score: Tensor, batch: GraphBatch,
                            ratio: Union[int, float],
                            min_score: Optional[float] = None,
                            s_inv_op: str = "transpose",
                            extras: Optional[dict] = None) -> SelectOutput:
    """Per-graph ranking of a precomputed ``score [N]``."""
    B = batch.num_graphs
    dev = score.device
    kmax = batch.max_nodes if min_score is not None else topk_budget(
        ratio, batch.max_nodes)
    node_graph = batch.node_graph
    if min_score is not None:
        # PyG ``topk``: threshold at min(max_g − tol, min_score) so the top
        # node of each graph survives
        smax = segment_max(score, node_graph, B, mask=batch.node_mask)
        thr = torch.minimum(smax - 1e-7, torch.tensor(min_score, device=dev))
        keep = batch.node_mask & (score > thr[node_graph.long()])
        rank = segment_topk_rank(score, node_graph, B, mask=keep)
    else:
        rank = segment_topk_rank(score, node_graph, B, mask=batch.node_mask)
        n_g = batch.nodes_per_graph()
        if isinstance(ratio, int) and ratio >= 1:
            k_g = torch.clamp(n_g, max=ratio)
        else:
            k_g = torch.clamp(torch.ceil(ratio * n_g.to(torch.float32)),
                              min=1).to(torch.int32)
        keep = batch.node_mask & (rank < k_g[node_graph.long()])

    num_clusters = B * kmax
    rank_c = torch.clamp(rank, max=kmax - 1)
    cluster_index = torch.where(keep, node_graph * kmax + rank_c, 0)
    ar = torch.arange(num_clusters, dtype=torch.int32, device=dev)
    return SelectOutput(
        cluster_index=cluster_index.to(torch.int32),
        weight=torch.where(keep, score, 0.0),
        node_sel_mask=keep,
        node_graph=node_graph,
        node_mask=batch.node_mask,
        cluster_graph=ar // kmax,
        cluster_pos=ar % kmax,
        num_clusters=num_clusters,
        num_graphs=B,
        max_clusters=kmax,
        partial=True,
        s_inv_op=s_inv_op,
        extras=extras or {},
    )


class TopkSelect(nn.Module):
    """Learnable-projection top-k selector: ``y = act(X·p/‖p‖)`` (or a
    per-graph softmax of ``X·p`` when ``min_score`` is set), then per-graph
    top-``ratio`` selection.  Scores are computed in f32."""

    def __init__(self, in_channels: Optional[int] = None,
                 ratio: Union[int, float] = 0.5,
                 min_score: Optional[float] = None,
                 act: Union[str, Callable, None] = "tanh",
                 s_inv_op: str = "transpose", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.ratio = ratio
        self.min_score = min_score
        self.act = act
        self.s_inv_op = s_inv_op
        if in_channels is not None and in_channels > 1:
            bound = 1.0 / math.sqrt(in_channels)
            # uniform(-bound, bound), PyG's ``uniform`` init
            self.weight = nn.Parameter(torch.empty(in_channels))
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        else:
            self.weight = None
        self.to(device)

    def raw_scores(self, x: Tensor) -> Tensor:
        """Row-wise pre-activation projection ``X·p/‖p‖``."""
        if self.weight is None:
            return x[..., 0] if x.dim() > 1 else x
        w = self.weight
        score = x.to(w.dtype) @ w
        if self.min_score is None:
            score = score / torch.clamp(torch.linalg.vector_norm(w),
                                        min=1e-12)
        return score

    def forward(self, batch: GraphBatch) -> SelectOutput:
        score = self.raw_scores(batch.x)
        if self.min_score is None:
            score = resolve_activation(self.act)(score)
        else:
            score = segment_softmax(score, batch.node_graph,
                                    batch.num_graphs, mask=batch.node_mask)
        return topk_select_from_scores(score, batch, self.ratio,
                                       self.min_score, self.s_inv_op)
