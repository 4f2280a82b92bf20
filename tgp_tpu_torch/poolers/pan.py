"""PANPooling (port of ``tgp_tpu/poolers/pan.py``; Ma et al., NeurIPS
2020).  Score ``β₀·(X·p) + β₁·deg(M)`` from :class:`~tgp_tpu_torch.mp.pan.
PANConv`'s MET matrix, then top-k and the subgraph connect over the MET
support, or with ``met_dense`` the exact pooled MET matrix."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig, sparse_connect
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch, from_dense
from tgp_tpu_torch.ops.segment import segment_softmax, segment_sum
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import topk_select_from_scores
from tgp_tpu_torch.src import PoolingOutput, SRCPooling
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["PANPooling"]

Tensor = torch.Tensor


class PANPooling(SRCPooling):
    """Path-integral pooling.  ``p`` (ones) and ``beta`` (0.5, 0.5) are the
    flax pooler's parameters.  The batch carries the MET connectivity
    (PANConv's ``met_edge_weight`` as ``edge_weight``); ``met_degree``
    overrides the degree term; ``met_dense`` (PANConv's
    ``return_dense_met``) pools the full MET matrix exactly
    (:meth:`_exact_met_connect`), with no long-range entry dropped."""

    IS_TRAINABLE = True

    def __init__(self, in_channels: int, ratio: Union[int, float] = 0.5,
                 min_score: Optional[float] = None, multiplier: float = 1.0,
                 nonlinearity: Union[str, Callable, None] = "tanh",
                 s_inv_op: str = "transpose", connect_red_op: str = "sum",
                 remove_self_loops: bool = False, degree_norm: bool = False,
                 edge_weight_norm: bool = False,
                 lift_op: str = "precomputed", lift_red_op: str = "sum", *,
                 device: DeviceLike = "cuda"):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.in_channels = in_channels
        self.ratio = ratio
        self.min_score = min_score
        self.multiplier = multiplier
        self.nonlinearity = nonlinearity
        self.s_inv_op = s_inv_op
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.p = nn.Parameter(torch.ones(in_channels))
        self.beta = nn.Parameter(torch.full((2,), 0.5))
        self.to(resolve_device(device))

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[Tensor] = None,
                met_degree: Optional[Tensor] = None,
                met_dense: Optional[Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            score1 = batch.x.to(self.p.dtype) @ self.p
            if met_degree is None:
                if met_dense is not None:
                    # column sums of M, read at each node
                    deg = met_dense.sum(-2)
                    met_degree = deg[batch.node_graph.long(),
                                     batch.node_pos.long()]
                else:
                    met_degree = segment_sum(batch.edge_weight,
                                             batch.receivers,
                                             batch.num_nodes,
                                             mask=batch.edge_mask)
            score = self.beta[0] * score1 + self.beta[1] * met_degree
            if self.min_score is None:
                score = resolve_activation(self.nonlinearity)(score)
            else:
                score = segment_softmax(score, batch.node_graph,
                                        batch.num_graphs,
                                        mask=batch.node_mask)
            so = topk_select_from_scores(score, batch, self.ratio,
                                         self.min_score, self.s_inv_op)
        x_pool = self.reduce(batch.x, so) * self.multiplier
        if met_dense is not None:
            return PoolingOutput(so=so, graph=self._exact_met_connect(
                x_pool, met_dense, so, batch))
        edges = sparse_connect(batch.senders, batch.receivers,
                               batch.edge_weight, batch.edge_mask, so,
                               self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))

    def _exact_met_connect(self, x_pool: Tensor, met_dense: Tensor,
                           so: SelectOutput, batch: GraphBatch
                           ) -> GraphBatch:
        """The pooled connectivity ``M[keep][:, keep]``: slot ``k`` of
        graph ``b`` reads dense position ``pos[b, k]`` of the kept node
        there, ``m_pool[b, k, j] = M[b, pos[b, k], pos[b, j]]`` on occupied
        slots (the JAX package's one-hot product ``P·M·Pᵀ``, as a gather),
        emitted as a block-diagonal batch of ``B·K²`` edge slots."""
        B, K = so.num_graphs, so.max_clusters
        keep = so.node_sel_mask
        # kept nodes' slots; the rest write to a spare slot dropped below
        slot = torch.where(keep, so.cluster_index.long(), B * K)
        pos = torch.zeros(B * K + 1, dtype=torch.long, device=keep.device)
        pos = pos.scatter(0, slot, batch.node_pos.long())[:-1].view(B, K)
        occupied = torch.zeros(B * K + 1, dtype=torch.bool,
                               device=keep.device)
        occupied = occupied.scatter(0, slot, keep)[:-1].view(B, K)
        b = torch.arange(B, device=keep.device)[:, None, None]
        m_pool = met_dense[b, pos[:, :, None], pos[:, None, :]]
        m_pool = torch.where(occupied[:, :, None] & occupied[:, None, :],
                             m_pool, 0.0)
        m_pool = postprocess_adj_dense(
            m_pool, remove_self_loops_flag=self.remove_self_loops,
            degree_norm=self.degree_norm,
            edge_weight_norm=self.edge_weight_norm)
        out_mask = so.out_mask()
        F = x_pool.shape[-1]
        dense = DenseGraphBatch(
            x=torch.where(out_mask[:, None], x_pool, 0.0).reshape(B, K, F),
            adj=m_pool, mask=out_mask.reshape(B, K))
        return from_dense(dense, keep_self_loops=not self.remove_self_loops)
