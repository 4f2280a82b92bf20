"""Scatter-free dense pipeline for batches of small graphs (port of
``tgp_tpu/models/fast_dense.py``): GCN → top-k pool → GCN → readout →
head, all on ``[B, N, ...]`` tensors.

Message passing is a batched adjacency product (the K3 kernel with
``use_kernel=True``), selection a per-graph top-k, pooling one-hot
products.  Densify and normalize the static adjacency once per batch,
outside the train step (:func:`~tgp_tpu_torch.mp.gcn.gcn_norm_dense`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch
from tgp_tpu_torch.models.classifiers import conv_step
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.poolers.topk import (dense_topk_apply, dense_topk_pool,
                                        gather_rows)
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["dense_topk_pool", "dense_topk_apply", "DenseTopkClassifier",
           "gather_rows"]


class DenseTopkClassifier(nn.Module):
    """GCN → top-k pool → GCN → readout → two-layer head on a
    :class:`DenseGraphBatch`.

    ``pre_normalized``: the input adjacency is already GCN-normalized (the
    pre layers skip normalization); the pooled adjacency is renormalized by
    the post layers unless ``post_normalize=False``.  ``compute_dtype``:
    the GCN layers' matmul dtype (weights stay f32; the input features are
    cast to it).  ``fast_masks``: skip the per-layer padding masks (padding
    scores are masked at selection and the readout is masked).
    ``use_kernel``: the adjacency products run the K3 kernel.  ``remat``:
    the GCN layers' activations are recomputed in the backward pass.  The
    selector's projection ``p`` is drawn uniform(±1/√hidden) from
    ``generator``.  Parameter names map onto the flax tree
    (:func:`~tgp_tpu_torch.models.convert.params_from_flax`)."""

    def __init__(self, num_classes: int, hidden: int = 64, ratio: float = 0.5,
                 num_pre_layers: int = 1, num_post_layers: int = 1,
                 readout: str = "sum", pre_normalized: bool = False,
                 post_normalize: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 fast_masks: bool = True, use_kernel: bool = False,
                 pool_impl: str = "auto", in_channels: Optional[int] = None,
                 remat: bool = False, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_channels = hidden if in_channels is None else in_channels
        self.ratio = ratio
        self.readout = readout
        self.compute_dtype = compute_dtype
        self.pool_impl = pool_impl
        self.remat = remat
        conv_kw = dict(mask_output=not fast_masks, use_kernel=use_kernel,
                       dtype=compute_dtype, device=device, generator=generator)
        self.pre_convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden, hidden,
                    normalize=not pre_normalized, **conv_kw)
            for i in range(num_pre_layers))
        pooled_ch = hidden if num_pre_layers else in_channels
        bound = 1.0 / math.sqrt(hidden)
        self.p = nn.Parameter(torch.empty(hidden))
        nn.init.uniform_(self.p, -bound, bound, generator=generator)
        self.post_convs = nn.ModuleList(
            GCNConv(pooled_ch if i == 0 else hidden, hidden,
                    normalize=post_normalize, **conv_kw)
            for i in range(num_post_layers))
        head_in = hidden if num_post_layers else pooled_ch
        self.dense_0 = lecun_normal_linear(head_in, hidden,
                                           generator=generator)
        self.dense_1 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, dense: DenseGraphBatch
                ) -> Tuple[torch.Tensor, DenseGraphBatch]:
        x = dense.x
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for conv in self.pre_convs:
            x = conv_step(conv, dense, x, self.remat)
        dense = DenseGraphBatch(x=x, adj=dense.adj, mask=dense.mask)
        p = self.p
        score = torch.tanh((x.to(p.dtype) @ p)
                           / torch.clamp(torch.linalg.vector_norm(p),
                                         min=1e-12))
        pooled = dense_topk_pool(dense, score, self.ratio,
                                 impl=self.pool_impl)
        h = pooled.x
        for conv in self.post_convs:
            h = conv_step(conv, pooled, h, self.remat)
        z = global_reduce(h.to(torch.float32), mask=pooled.mask,
                          op=self.readout)
        z = F.relu(self.dense_0(z))
        return self.dense_1(z), pooled
