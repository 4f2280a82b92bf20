"""LEConv, the local-extremum convolution (port of
``tgp_tpu/mp/leconv.py``; PyG's ``LEConv``, ASAP's select scorer):

``x'_i = W₃x_i + b₃ + Σ_{j→i} w_{ji} ((W₁x_j + b₁) − W₂x_i)``

``lin``, ``lin_1`` and ``lin_2`` are the flax layer's ``Dense_0``
(neighbour projection, with bias), ``Dense_1`` (self projection) and
``Dense_2`` (root, with bias).  The ``Σ w_{ji} b₁`` term depends on the
degree, so where the bias sits matters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.segment import gather_rows, segment_sum
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["LEConv"]

Tensor = torch.Tensor


class LEConv(nn.Module):
    """Call as ``conv(x, senders, receivers, edge_weight, num_nodes,
    node_mask=None)``; padding edges must carry weight 0.  Output zero on
    nodes outside ``node_mask`` when it is given."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = lecun_normal_linear(in_channels, out_channels,
                                       generator=generator)
        self.lin_1 = lecun_normal_linear(in_channels, out_channels,
                                         bias=False, generator=generator)
        self.lin_2 = lecun_normal_linear(in_channels, out_channels,
                                         generator=generator)
        self.to(resolve_device(device))

    def forward(self, x: Tensor, senders: Tensor, receivers: Tensor,
                edge_weight: Tensor, num_nodes: int,
                node_mask: Optional[Tensor] = None) -> Tensor:
        a = apply_linear(self.lin, x)
        b = apply_linear(self.lin_1, x)
        root = apply_linear(self.lin_2, x)
        s, r = senders.long(), receivers.long()
        msg = edge_weight[:, None] * (gather_rows(a, s, x.shape[0])
                                      - gather_rows(b, r, x.shape[0]))
        out = root + segment_sum(msg, receivers, num_nodes)
        if node_mask is not None:
            out = torch.where(node_mask[:, None], out, 0.0)
        return out
