"""Hierarchical autoencoder for node-level tasks (port of
``tgp_tpu/models/autoencoder.py``): encoder GCN → pool → bottleneck GCN on
the pooled graph → lift → decoder GCN on ``[h, lifted]`` → per-node
logits."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.ops.segment import node_rows
from tgp_tpu_torch.src import PoolingOutput
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["PoolLiftNodeClassifier"]


class PoolLiftNodeClassifier(nn.Module):
    """The layers are flax's: ``conv`` (encoder, ``GCNConv_0``),
    ``conv_1`` (bottleneck on the pooled graph, sparse or dense),
    ``conv_2`` (decoder) and ``dense_0`` (the head); ``in_channels`` is the
    input width (default ``hidden``).  A dense pooler's ``[B, Nmax, F]``
    lift is re-packed into the flat node space by
    :func:`~tgp_tpu_torch.ops.segment.node_rows` (zero on padding nodes,
    whose rows no output reads), so its gradient is an indexed write and
    not a float sum."""

    def __init__(self, pooler: nn.Module, num_classes: int, hidden: int = 64,
                 in_channels: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_channels = hidden if in_channels is None else in_channels
        kw = dict(device=device, generator=generator)
        self.conv = GCNConv(in_channels, hidden, **kw)
        self.pooler = pooler
        self.conv_1 = GCNConv(hidden, hidden, **kw)
        self.conv_2 = GCNConv(2 * hidden, hidden, **kw)
        self.dense_0 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, batch: GraphBatch
                ) -> Tuple[torch.Tensor, PoolingOutput]:
        h = F.relu(self.conv(batch))
        enc = batch.with_features(h)
        out: PoolingOutput = self.pooler(enc)
        pooled = out.graph if out.graph is not None else out.dense
        hp = F.relu(self.conv_1(pooled))
        x_lift = self.pooler(enc, so=out.so, lifting=True, x=hp)
        if x_lift.dim() == 3:  # a dense pooler lifts to [B, Nmax, F]
            x_lift = node_rows(x_lift, batch.node_graph, batch.node_pos,
                               batch.node_mask)
        h = F.relu(self.conv_2(batch, torch.cat([h, x_lift], dim=-1)))
        return self.dense_0(h), out
