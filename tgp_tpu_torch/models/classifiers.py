"""End-to-end graph classifier (port of ``PoolingClassifier`` in
``tgp_tpu/models/classifiers.py``): GCN → pool → GCN → readout → MLP head,
on a sparse ``GraphBatch`` or a ``DenseGraphBatch`` (route small graphs to
the dense side with :func:`~tgp_tpu_torch.models.prepare.prepare_batch`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.src import PoolingOutput
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["PoolingClassifier", "conv_step"]


def conv_step(conv: nn.Module, batch, x: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """``relu(conv(batch, x))``; with ``remat`` (and a gradient being
    taken) its activations are recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of kept."""
    if remat and torch.is_grad_enabled():
        return F.relu(checkpoint(conv, batch, x, use_reentrant=False))
    return F.relu(conv(batch, x))


class PoolingClassifier(nn.Module):
    """GCN → pool → GCN → readout → two-layer head.

    Casts follow the JAX model: the GCN layers compute in
    ``compute_dtype`` (bf16 or f32) and add their f32 bias; the selector
    scores in f32; the readout and the head run in f32.  ``in_channels``
    is the input feature width (default: ``hidden``).  Parameter names
    map one to one onto the flax tree (:func:`~tgp_tpu_torch.models.
    convert.params_from_flax`).

    Dense input (the pooler must accept it): the features are cast to
    ``compute_dtype``; ``pre_normalized`` says the adjacency is already
    GCN-normalized (``prepare_batch(normalize=True)``), so the pre layers
    skip normalization; ``fast_masks`` skips the per-layer padding masks;
    ``use_kernel=True`` runs the adjacency products in the K3 kernel
    (``None`` means False there, as in JAX).  These flags do not change the
    sparse path.  ``remat`` recomputes the GCN layers' activations in the
    backward pass (:func:`conv_step`); the parameters are the same.
    """

    def __init__(self, pooler: nn.Module, num_classes: int, hidden: int = 64,
                 num_pre_layers: int = 1, num_post_layers: int = 1,
                 readout: str = "sum", use_kernel: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 in_channels: Optional[int] = None,
                 pre_normalized: bool = False, fast_masks: bool = False,
                 remat: bool = False, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_channels = hidden if in_channels is None else in_channels
        self.readout = readout
        self.compute_dtype = compute_dtype
        self.remat = remat
        conv_kw = dict(use_kernel=use_kernel, dtype=compute_dtype,
                       mask_output=not fast_masks, device=device,
                       generator=generator)
        self.pre_convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden, hidden,
                    normalize=not pre_normalized, **conv_kw)
            for i in range(num_pre_layers))
        pooled_ch = hidden if num_pre_layers else in_channels
        self.pooler = pooler
        self.post_convs = nn.ModuleList(
            GCNConv(pooled_ch if i == 0 else hidden, hidden, **conv_kw)
            for i in range(num_post_layers))
        head_in = hidden if num_post_layers else pooled_ch
        self.dense_0 = lecun_normal_linear(head_in, hidden,
                                           generator=generator)
        self.dense_1 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, batch) -> Tuple[torch.Tensor, PoolingOutput]:
        x = batch.x
        if (isinstance(batch, DenseGraphBatch)
                and self.compute_dtype is not None):
            x = x.to(self.compute_dtype)
        for conv in self.pre_convs:
            x = conv_step(conv, batch, x, self.remat)
        out: PoolingOutput = self.pooler(batch.with_features(x))
        pooled = out.graph if out.graph is not None else out.dense
        h = pooled.x
        for conv in self.post_convs:
            h = conv_step(conv, pooled, h, self.remat)
        where = (dict(mask=pooled.mask) if out.graph is None else dict(
            node_graph=pooled.node_graph, num_graphs=pooled.num_graphs,
            node_mask=pooled.node_mask))
        z = global_reduce(h.to(torch.float32), op=self.readout, **where)
        z = F.relu(self.dense_0(z))
        return self.dense_1(z), out
