"""Top-k selection (port of ``tgp_tpu/select/topk.py``).

Sparse batch: scores are ranked within each graph (:func:`~tgp_tpu_torch.
ops.segment.segment_topk_rank`); node *i* is kept iff ``rank < ceil(ratio ·
n_g)`` and becomes supernode ``g_i · Kmax + rank_i`` in a graph-major
static id space of ``B · Kmax`` slots (``Kmax = ceil(ratio · max_nodes)``).

Dense batch: a per-graph top-k over the padded ``[B, N]`` scores
(:func:`dense_topk_indices`), ties broken toward the lower index as
``jax.lax.top_k`` does, with a scatter-free gradient for the score gate.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.ops.segment import (segment_max, segment_softmax,
                                       segment_topk_rank)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["topk_budget", "topk_select_from_scores", "dense_topk_indices",
           "dense_topk_select_output", "TopkSelect"]

Tensor = torch.Tensor


def topk_budget(ratio: Union[int, float], max_nodes: int) -> int:
    """Static per-graph supernode budget ``Kmax``."""
    if isinstance(ratio, int) and ratio >= 1:
        return min(ratio, max_nodes)
    return max(int(math.ceil(ratio * max_nodes)), 1)


class _TopkValues(torch.autograd.Function):
    """``top_scores`` (= ``ranked`` gathered at ``idx``) as they are, with
    the gradient of the gather as a one-hot contraction (``_topk_values_vjp``,
    ``select/topk.py:34-66``).  ``top_scores`` gets a zero cotangent."""

    @staticmethod
    def forward(ctx, ranked, idx, top_scores):
        ctx.save_for_backward(idx)
        ctx.n = ranked.shape[1]
        return top_scores.view_as(top_scores)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        ar = torch.arange(ctx.n, dtype=idx.dtype, device=idx.device)
        onehot = (idx[:, :, None] == ar[None, None, :]).to(torch.float32)
        # one 0/1 term per output: exact in f32 (TF32 off)
        d_ranked = torch.einsum("bk,bkn->bn", g.to(torch.float32), onehot)
        return d_ranked.to(g.dtype), None, torch.zeros_like(g)


def dense_topk_indices(score: Tensor, mask: Tensor,
                       ratio: Union[int, float],
                       min_score: Optional[float] = None):
    """Per-graph top-k over the padded ``[B, N]`` score matrix.

    ``min_score``: keep nodes with ``score > min(max_g − 1e-7,
    min_score)`` (at least the top node of each graph survives) and a slot
    budget of ``N``.  Returns ``(idx [B,K], slot_mask [B,K], gate [B,K])``:
    kept-node indices, score-descending with ties toward the lower index
    (a stable sort, as ``jax.lax.top_k`` orders them); slot validity, a
    prefix of each row; and the score gate, 0 on invalid slots."""
    B, N = score.shape
    neg = torch.finfo(score.dtype).min
    ranked = torch.where(mask, score, neg)
    K = N if min_score is not None else topk_budget(ratio, N)
    srt = torch.sort(ranked.detach(), dim=-1, descending=True, stable=True)
    top_scores, idx = srt.values[:, :K], srt.indices[:, :K]
    if min_score is not None:
        thr = torch.clamp(top_scores[:, :1] - 1e-7, max=min_score)
        slot_mask = top_scores > thr
    else:
        n_g = mask.sum(-1)
        if isinstance(ratio, int) and ratio >= 1:
            k_g = torch.clamp(n_g, max=ratio)
        else:
            k_g = torch.clamp(torch.ceil(ratio * n_g.to(torch.float32)),
                              min=1).to(torch.int64)
        ar = torch.arange(K, device=score.device)
        slot_mask = ar[None, :] < k_g[:, None]
    slot_mask = slot_mask & (top_scores > neg)  # empty graphs stay empty
    gate = torch.where(slot_mask, _TopkValues.apply(ranked, idx, top_scores),
                       0.0)
    return idx, slot_mask, gate


def dense_topk_select_output(score: Tensor, mask: Tensor,
                             ratio: Union[int, float],
                             min_score: Optional[float] = None,
                             s_inv_op: str = "transpose") -> SelectOutput:
    """Dense-layout :class:`SelectOutput` of a top-k selection: ``idx``,
    ``slot_mask`` and ``gate`` in ``extras`` for the pooling path
    (:func:`tgp_tpu_torch.poolers.topk.dense_topk_apply`); ``s[b, n, k] =
    gate[b, k] · 1[idx[b, k] = n]`` is built from them when read."""
    B = score.shape[0]
    idx, slot_mask, gate = dense_topk_indices(score, mask, ratio, min_score)
    K = idx.shape[1]
    return SelectOutput(
        in_mask=mask, cluster_mask=slot_mask,
        extras={"idx": idx, "slot_mask": slot_mask, "gate": gate},
        num_clusters=B * K, num_graphs=B, max_clusters=K, partial=True,
        s_inv_op=s_inv_op)


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
        thr = torch.clamp(smax - 1e-7, max=min_score)
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

    def raw_scores(self, x: Tensor, dense: bool = False) -> Tensor:
        """Row-wise pre-activation projection ``X·p/‖p‖``."""
        if self.weight is None:
            return x[..., 0] if x.dim() > (2 if dense else 1) else x
        w = self.weight
        score = x.to(w.dtype) @ w
        if self.min_score is None:
            score = score / torch.clamp(torch.linalg.vector_norm(w),
                                        min=1e-12)
        return score

    def forward(self, batch) -> SelectOutput:
        dense = isinstance(batch, DenseGraphBatch)
        score = self.raw_scores(batch.x, dense)
        if dense:
            if self.min_score is None:
                score = resolve_activation(self.act)(score)
            else:
                neg = torch.finfo(score.dtype).min
                score = torch.softmax(torch.where(batch.mask, score, neg),
                                      dim=-1)
            return dense_topk_select_output(score, batch.mask, self.ratio,
                                            self.min_score, self.s_inv_op)
        if self.min_score is None:
            score = resolve_activation(self.act)(score)
        else:
            score = segment_softmax(score, batch.node_graph,
                                    batch.num_graphs, mask=batch.node_mask)
        return topk_select_from_scores(score, batch, self.ratio,
                                       self.min_score, self.s_inv_op)
