"""MLP soft-assignment selector (port of ``tgp_tpu/select/mlp.py``):
``S = softmax(MLP(X))`` with padded rows zeroed.  Batched mode takes a
:class:`~tgp_tpu_torch.graph.DenseGraphBatch` and gives ``s [B, N, K]``;
unbatched mode takes a flat :class:`~tgp_tpu_torch.graph.GraphBatch` and
gives the unbatched ``[N, K]`` assignment, with the batch's ``node_pos``
and ``max_nodes`` for the per-graph products of reduce, connect and
lift."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.utils.activations import resolve_activation
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["MLPSelect", "SelectMLP"]


class SelectMLP(nn.Module):
    """A plain MLP head: ``channels[0]`` is the input width, each further
    entry a hidden layer (activation ``act``, default ReLU, then dropout),
    and a last layer to ``k``.  ``layers[i]`` is flax's ``Dense_i``.
    Dropout acts only in training mode, drawing from
    ``dropout_generator`` (on the module's device; None draws from
    torch's default generator)."""

    def __init__(self, channels: Sequence[int], k: int,
                 act: Optional[str] = None, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if channels[0] is None:
            raise ValueError("SelectMLP needs the input width channels[0]")
        self.act = resolve_activation(act) if act else F.relu
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        widths = list(channels) + [k]
        self.layers = nn.ModuleList(
            lecun_normal_linear(a, b, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = self.act(apply_linear(lin, x))
            if self.dropout > 0 and self.training:
                keep_p = 1.0 - self.dropout
                u = torch.rand(x.shape, generator=self.dropout_generator,
                               device=x.device)
                x = torch.where(u < keep_p, x / keep_p, 0.0)
        return apply_linear(self.layers[-1], x)


class MLPSelect(nn.Module):
    """``S = softmax(MLP(X))``, masked.  ``in_channels``: the input width,
    or a list of it and the hidden widths."""

    def __init__(self, in_channels: Union[int, List[int]], k: int = 8,
                 batched: bool = True, act: Optional[str] = None,
                 dropout: float = 0.0, s_inv_op: str = "transpose", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        ch = ([in_channels] if in_channels is None
              or isinstance(in_channels, int) else list(in_channels))
        self.k = k
        self.batched = batched
        self.s_inv_op = s_inv_op
        self.mlp = SelectMLP(ch, k, act, dropout, generator=generator,
                             dropout_generator=dropout_generator)
        self.to(resolve_device(device))

    def forward(self, batch) -> SelectOutput:
        s = torch.softmax(self.mlp(batch.x), dim=-1)
        if self.batched:
            if not isinstance(batch, DenseGraphBatch):
                raise TypeError("batched MLPSelect expects a DenseGraphBatch")
            return SelectOutput(
                batched_s=s * batch.mask[..., None], in_mask=batch.mask,
                num_clusters=self.k, num_graphs=batch.num_graphs,
                max_clusters=self.k, s_inv_op=self.s_inv_op)
        if not isinstance(batch, GraphBatch):
            raise TypeError("unbatched MLPSelect expects a flat GraphBatch")
        return SelectOutput(
            assignment=s * batch.node_mask[:, None],
            node_graph=batch.node_graph, node_mask=batch.node_mask,
            node_pos=batch.node_pos, max_nodes=batch.max_nodes,
            num_clusters=self.k, num_graphs=batch.num_graphs,
            max_clusters=self.k, s_inv_op=self.s_inv_op)
