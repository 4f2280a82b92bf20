"""SAGPooling (port of ``tgp_tpu/poolers/sag.py``; Lee et al., ICML 2019):
top-k selection on a GNN-computed attention score ``a = GNN(X, A)``.

The default scorer is :class:`~tgp_tpu_torch.mp.gcn.GraphConv` to width 1,
whose ``A X`` runs the CSR kernel (K1) at the input width on a sorted
large batch; pooling is compact or masked as in
:class:`~tgp_tpu_torch.poolers.topk.TopkPooling`.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from tgp_tpu_torch import tracing
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv, GraphConv
from tgp_tpu_torch.mp.leconv import LEConv
from tgp_tpu_torch.ops.segment import segment_softmax
from tgp_tpu_torch.poolers._masked import (masked_lift, masked_pool,
                                           use_masked_pool)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import topk_select_from_scores
from tgp_tpu_torch.src import PoolingOutput, SRCPooling
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["SAGPooling"]

Tensor = torch.Tensor


class SAGPooling(SRCPooling):
    """Self-attention graph pooling.

    ``gnn_kind``: the scorer, ``"graph_conv"`` (default), ``"gcn"`` or
    ``"le"``, each to width 1 from ``in_channels``; ``score_gnn``: any
    module mapping ``(batch, x)`` to a score ``[N]`` or ``[N, 1]``, which
    overrides it.  The score is ``nonlinearity(GNN(X, A))``, or with
    ``min_score`` a per-graph softmax of it, and the kept nodes are gated
    by it times ``multiplier``.  ``pool_mode`` and the connect flags are
    :class:`~tgp_tpu_torch.poolers.topk.TopkPooling`'s.  ``use_kernel``
    reaches the GraphConv and GCN scorers (their ``use_kernel``).

    Traced as ``tgp.model.pool.score`` (the scorer) and
    ``tgp.model.pool.select`` (the per-graph ranking) where it selects."""

    IS_TRAINABLE = True

    def __init__(self, in_channels: int, ratio: Union[int, float] = 0.5,
                 min_score: Optional[float] = None, multiplier: float = 1.0,
                 nonlinearity: Union[str, Callable, None] = "tanh",
                 gnn_kind: str = "graph_conv",
                 score_gnn: Optional[nn.Module] = None,
                 s_inv_op: str = "transpose", connect_red_op: str = "sum",
                 remove_self_loops: bool = True, degree_norm: bool = False,
                 edge_weight_norm: bool = False, pool_mode: str = "auto",
                 lift_op: str = "precomputed", lift_red_op: str = "sum",
                 use_kernel: Optional[bool] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        device = resolve_device(device)
        self.in_channels = in_channels
        self.ratio = ratio
        self.min_score = min_score
        self.multiplier = multiplier
        self.nonlinearity = nonlinearity
        self.gnn_kind = gnn_kind
        self.s_inv_op = s_inv_op
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.remove_self_loops = remove_self_loops
        self.pool_mode = pool_mode
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.user_gnn = score_gnn is not None
        kw = dict(device=device, generator=generator)
        if score_gnn is not None:
            self.gnn = score_gnn
        elif gnn_kind == "graph_conv":
            self.gnn = GraphConv(in_channels, 1, use_kernel=use_kernel, **kw)
        elif gnn_kind == "gcn":
            self.gnn = GCNConv(in_channels, 1, use_kernel=use_kernel, **kw)
        elif gnn_kind == "le":
            self.gnn = LEConv(in_channels, 1, **kw)
        else:
            raise ValueError(
                f"gnn_kind must be graph_conv|gcn|le, got {gnn_kind!r}")

    def score(self, batch: GraphBatch, attn: Optional[Tensor] = None
              ) -> Tensor:
        """The activated per-node score ``[N]`` (the JAX pooler's
        ``score``); ``attn`` replaces ``batch.x`` as the scorer's input."""
        if self.user_gnn:
            score = self.gnn(batch, attn)
            score = score[:, 0] if score.dim() > 1 else score
        elif self.gnn_kind == "le":
            score = self.gnn(attn if attn is not None else batch.x,
                             batch.senders, batch.receivers,
                             batch.edge_weight, batch.num_nodes,
                             batch.node_mask)[:, 0]
        else:
            score = self.gnn(batch, attn)[:, 0]
        if self.min_score is None:
            return resolve_activation(self.nonlinearity)(score)
        return segment_softmax(score, batch.node_graph, batch.num_graphs,
                               mask=batch.node_mask)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[Tensor] = None,
                attn: Optional[Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            with tracing.span("tgp.model.pool.score"):
                score = self.score(batch, attn)
            with tracing.span("tgp.model.pool.select"):
                so = topk_select_from_scores(score, batch, self.ratio,
                                             self.min_score, self.s_inv_op)
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

    def lift(self, x_pool: Tensor, so: SelectOutput) -> Tensor:
        if so.extras.get("pool_mode") == "masked":
            return masked_lift(x_pool, so, self.s_inv_op)
        return super().lift(x_pool, so)
