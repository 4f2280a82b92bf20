"""End-to-end graph classifier (port of ``PoolingClassifier`` in
``tgp_tpu/models/classifiers.py``, sparse ``GraphBatch`` input):
GCN → pool → GCN → readout → MLP head."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.src import PoolingOutput

__all__ = ["PoolingClassifier"]


def _lecun_normal_linear(n_in: int, n_out: int, generator) -> nn.Linear:
    """``nn.Linear`` initialised like flax's ``nn.Dense``: truncated-normal
    kernel with variance 1/fan_in, zero bias."""
    lin = nn.Linear(n_in, n_out)
    # flax's variance_scaling divides by the std of a [-2, 2]-truncated
    # standard normal so the truncated draw keeps variance 1/fan_in
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


class PoolingClassifier(nn.Module):
    """GCN → pool → GCN → readout → two-layer head.

    Casts follow the JAX model: the GCN layers compute in
    ``compute_dtype`` (bf16 or f32) and add their f32 bias; the selector
    scores in f32; the readout and the head run in f32.  ``in_channels``
    is the input feature width (default: ``hidden``).  Parameter names
    map one to one onto the flax tree (:func:`~tgp_tpu_torch.models.
    convert.params_from_flax`).
    """

    def __init__(self, pooler: nn.Module, num_classes: int, hidden: int = 64,
                 num_pre_layers: int = 1, num_post_layers: int = 1,
                 readout: str = "sum", use_kernel: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 in_channels: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_channels = hidden if in_channels is None else in_channels
        self.readout = readout
        conv_kw = dict(use_kernel=use_kernel, dtype=compute_dtype,
                       device=device, generator=generator)
        self.pre_convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden, hidden, **conv_kw)
            for i in range(num_pre_layers))
        pooled_ch = hidden if num_pre_layers else in_channels
        self.pooler = pooler
        self.post_convs = nn.ModuleList(
            GCNConv(pooled_ch if i == 0 else hidden, hidden, **conv_kw)
            for i in range(num_post_layers))
        head_in = hidden if num_post_layers else pooled_ch
        self.dense_0 = _lecun_normal_linear(head_in, hidden, generator)
        self.dense_1 = _lecun_normal_linear(hidden, num_classes, generator)
        self.to(device)

    def forward(self, batch: GraphBatch
                ) -> Tuple[torch.Tensor, PoolingOutput]:
        x = batch.x
        for conv in self.pre_convs:
            x = F.relu(conv(batch, x))
        out: PoolingOutput = self.pooler(batch.with_features(x))
        pooled = out.graph
        h = pooled.x
        for conv in self.post_convs:
            h = F.relu(conv(pooled, h))
        z = global_reduce(h.to(torch.float32), node_graph=pooled.node_graph,
                          num_graphs=pooled.num_graphs,
                          node_mask=pooled.node_mask, op=self.readout)
        z = F.relu(self.dense_0(z))
        return self.dense_1(z), out
