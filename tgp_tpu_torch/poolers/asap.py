"""ASAPooling (port of ``tgp_tpu/poolers/asap.py``; Ranjan et al., AAAI
2020).

Ego-network attention: ``x_q_i = lin(max_{j→i} x_j)``, a score per edge
``att([x_q_i ‖ x_j])`` (leaky ReLU, softmax over each receiver's edges,
dropout in training mode), cluster features ``x_i = Σ_j score_e · x_j``;
selection is top-k on an LEConv fitness of the cluster features, connect
the kept-node subgraph of the self-loop-augmented edges.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig, sparse_connect
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv, GraphConv
from tgp_tpu_torch.mp.leconv import LEConv
from tgp_tpu_torch.ops.segment import (gather_rows, segment_max,
                                       segment_softmax, segment_sum)
from tgp_tpu_torch.ops.sparse import add_remaining_self_loops
from tgp_tpu_torch.reduce.base import reduce_sparse
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import topk_select_from_scores
from tgp_tpu_torch.src import PoolingOutput, SRCPooling
from tgp_tpu_torch.utils.activations import resolve_activation
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["ASAPooling"]

Tensor = torch.Tensor


class ASAPooling(SRCPooling):
    """Adaptive structure-aware pooling.

    ``lin``, ``att`` and ``select_scorer`` (an :class:`~tgp_tpu_torch.mp.
    leconv.LEConv` to width 1) are the flax pooler's layers of the same
    names; ``intra_gnn`` (None, ``"graph_conv"`` or ``"gcn"``) adds
    ``gnn_intra_cluster``, whose output the attention reads in place of
    the input features.  ``add_self_loops``: each node is in its own ego
    network.  ``dropout`` acts on the normalized attention only in
    training mode, drawing from ``dropout_generator`` (on the pooler's
    device; None draws from torch's default generator)."""

    IS_TRAINABLE = True

    def __init__(self, in_channels: int, ratio: Union[int, float] = 0.5,
                 dropout: float = 0.0, negative_slope: float = 0.2,
                 nonlinearity: Union[str, Callable, None] = "sigmoid",
                 intra_gnn: Optional[str] = None, add_self_loops: bool = True,
                 s_inv_op: str = "transpose", connect_red_op: str = "sum",
                 remove_self_loops: bool = True, degree_norm: bool = False,
                 edge_weight_norm: bool = False,
                 lift_op: str = "precomputed", lift_red_op: str = "sum", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        device = resolve_device(device)
        self.in_channels = in_channels
        self.ratio = ratio
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity
        self.add_self_loops = add_self_loops
        self.s_inv_op = s_inv_op
        self.dropout_generator = dropout_generator
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        kw = dict(device=device, generator=generator)
        self.lin = lecun_normal_linear(in_channels, in_channels,
                                       generator=generator)
        self.att = lecun_normal_linear(2 * in_channels, 1,
                                       generator=generator)
        self.select_scorer = LEConv(in_channels, 1, **kw)
        if intra_gnn == "graph_conv":
            self.gnn_intra_cluster = GraphConv(in_channels, in_channels, **kw)
        elif intra_gnn == "gcn":
            self.gnn_intra_cluster = GCNConv(in_channels, in_channels, **kw)
        elif intra_gnn is not None:
            raise ValueError(
                f"intra_gnn must be None|graph_conv|gcn, got {intra_gnn!r}")
        self.intra_gnn = intra_gnn
        self.to(device)

    def _drop(self, score_e: Tensor) -> Tensor:
        """Dropout of rate ``dropout`` (kept entries scaled by 1/(1−p),
        as flax's ``nn.Dropout``)."""
        keep_p = 1.0 - self.dropout
        u = torch.rand(score_e.shape, generator=self.dropout_generator,
                       device=score_e.device)
        return torch.where(u < keep_p, score_e / keep_p, 0.0)

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        N = batch.num_nodes
        s, r, w, em = (batch.senders, batch.receivers, batch.edge_weight,
                       batch.edge_mask)
        if self.add_self_loops:
            s, r, w, em = add_remaining_self_loops(s, r, w, em,
                                                   batch.node_mask, 1.0)
        sl, rl = s.long(), r.long()
        x_in = batch.x
        x_pool = (x_in if self.intra_gnn is None
                  else self.gnn_intra_cluster(batch))
        # rows by gather_rows: its gradient sums each node's rows in a
        # fixed order
        x_pool_s = gather_rows(x_pool, sl, N)

        # ego-network attention; an empty ego network reads 0
        x_q = segment_max(x_pool_s, r, N, mask=em)
        x_q = torch.where(torch.isfinite(x_q), x_q, 0.0)
        x_q = apply_linear(self.lin, x_q)
        score_e = apply_linear(self.att, torch.cat(
            [gather_rows(x_q, rl, N), x_pool_s], -1))[:, 0]
        score_e = F.leaky_relu(score_e, self.negative_slope)
        score_e = segment_softmax(score_e, r, N, mask=em)
        if self.dropout > 0 and self.training:
            score_e = self._drop(score_e)

        v = gather_rows(x_in, sl, N) * score_e[:, None]
        x_clustered = segment_sum(v, r, N, mask=em)

        fitness = self.select_scorer(x_clustered, s, r,
                                     torch.where(em, w, 0.0), N,
                                     node_mask=batch.node_mask)[:, 0]
        fitness = resolve_activation(self.nonlinearity)(fitness)
        if so is None:
            so = topk_select_from_scores(fitness, batch, self.ratio, None,
                                         self.s_inv_op)
        x_pooled = reduce_sparse(x_clustered, so)
        edges = sparse_connect(s, r, w, em, so, self.connect_cfg)
        return PoolingOutput(
            so=so, graph=self.pooled_graph(x_pooled, edges, so, batch))
