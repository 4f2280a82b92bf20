"""End-to-end graph classifiers: ``PoolingClassifier`` (port of
``tgp_tpu/models/classifiers.py``), GCN → pool → GCN → readout → MLP head,
on a sparse ``GraphBatch`` or a ``DenseGraphBatch`` (route small graphs to
the dense side with :func:`~tgp_tpu_torch.models.prepare.prepare_batch`);
and ``HierarchicalClassifier``, SAGPool's hierarchical model: a block of
GCN → pool → readout for each pooler, the readouts summed, an MLP head."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tgp_tpu_torch import tracing
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.models.graph_replay import GraphReplay
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.src import PoolingOutput
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["PoolingClassifier", "HierarchicalClassifier", "conv_step"]


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

    A sparse batch on a CUDA device, with no gradient taken and a pooler
    whose ``CAPTURABLE`` flag is set, is served from CUDA graphs
    (:class:`~tgp_tpu_torch.models.graph_replay.GraphReplay`): the first
    call of a batch signature runs eagerly, the second captures it, later
    ones replay it; the logits and the selection are the eager forward's
    bit for bit.  Every other call runs eagerly.
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
        self._graphs = GraphReplay()

    def forward(self, batch) -> Tuple[torch.Tensor, PoolingOutput]:
        """Traced as ``tgp.model.forward`` (with ``launches``, and
        ``graph``: ``"eager"``, ``"capture"`` or ``"replay"``) around, when
        it runs eagerly or captures, ``tgp.model.conv`` (each),
        ``tgp.model.pool`` and ``tgp.model.readout`` (the readout and the
        head)."""
        with tracing.span("tgp.model.forward", count_launches=True) as sp:
            if self._replayable(batch):
                how, (logits, out) = self._graphs.run(self._forward, batch,
                                                      self)
            else:
                how, (logits, out) = "eager", self._forward(batch)
            if sp:
                sp.set(graph=how)
        return logits, out

    def _replayable(self, batch) -> bool:
        """No gradient taken, a sparse batch on the card (and no capture
        of the caller's under way), a pooler marked ``CAPTURABLE``."""
        return (not torch.is_grad_enabled()
                and isinstance(batch, GraphBatch) and batch.x.is_cuda
                and getattr(self.pooler, "CAPTURABLE", False)
                and not torch.cuda.is_current_stream_capturing())

    def _forward(self, batch) -> Tuple[torch.Tensor, PoolingOutput]:
        x = batch.x
        if (isinstance(batch, DenseGraphBatch)
                and self.compute_dtype is not None):
            x = x.to(self.compute_dtype)
        for conv in self.pre_convs:
            with tracing.span("tgp.model.conv"):
                x = conv_step(conv, batch, x, self.remat)
        with tracing.span("tgp.model.pool"):
            out: PoolingOutput = self.pooler(batch.with_features(x))
        pooled = out.graph if out.graph is not None else out.dense
        h = pooled.x
        for conv in self.post_convs:
            with tracing.span("tgp.model.conv"):
                h = conv_step(conv, pooled, h, self.remat)
        where = (dict(mask=pooled.mask) if out.graph is None else dict(
            node_graph=pooled.node_graph, num_graphs=pooled.num_graphs,
            node_mask=pooled.node_mask))
        with tracing.span("tgp.model.readout"):
            z = global_reduce(h.to(torch.float32), op=self.readout,
                              **where)
            logits = self.dense_1(F.relu(self.dense_0(z)))
        return logits, out


class HierarchicalClassifier(nn.Module):
    """SAGPool's hierarchical classifier (Lee et al., ICML 2019, §3.2):
    one block a pooler, each ``relu(GCN)`` → pooler → readout of the
    pooled graph, then the sum of the blocks' readouts through a head of
    ReLU layers of widths ``head`` and the output layer.  With three
    ``get_pooler("sag", gnn_kind="gcn")`` poolers, ``readout="max_mean"``
    and ``head=(128, 64)`` it is the published SAGPool_h (without its
    dropout).

    ``readout``: :func:`~tgp_tpu_torch.reduce.global_reduce.global_reduce`
    ops joined by ``_``, concatenated in that order (``"max_mean"``:
    ``[max ‖ mean]``).  Casts follow :class:`PoolingClassifier`: the GCN
    layers compute in ``compute_dtype`` and add their f32 bias, the
    poolers score in f32, the readouts and the head run in f32.  Sparse
    batches only; each pooler returns a sparse pooled graph (compact or
    masked), which the next block takes as its input.
    """

    def __init__(self, poolers: Sequence[nn.Module], num_classes: int,
                 hidden: int = 128, in_channels: Optional[int] = None,
                 readout: str = "max_mean", head: Sequence[int] = (128, 64),
                 compute_dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_channels = hidden if in_channels is None else in_channels
        self.readout_ops = readout.split("_")
        self.convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden, hidden,
                    dtype=compute_dtype, device=device, generator=generator)
            for i in range(len(poolers)))
        self.poolers = nn.ModuleList(poolers)
        widths = [hidden * len(self.readout_ops), *head, num_classes]
        self.head = nn.ModuleList(
            lecun_normal_linear(a, b, generator=generator)
            for a, b in zip(widths, widths[1:]))
        self.to(device)

    def forward(self, batch) -> Tuple[torch.Tensor, List[PoolingOutput]]:
        """Logits and each block's :class:`PoolingOutput`.  Traced as
        ``tgp.model.forward`` (with ``launches``) around, a block,
        ``tgp.model.conv``, ``tgp.model.pool`` (``level``; ``slots``: the
        pooled graph's node slots) and ``tgp.model.readout`` (``level``),
        then ``tgp.model.head``."""
        with tracing.span("tgp.model.forward", count_launches=True):
            x, outs, z = batch.x, [], None
            for level, (conv, pooler) in enumerate(zip(self.convs,
                                                       self.poolers)):
                with tracing.span("tgp.model.conv"):
                    x = F.relu(conv(batch, x))
                with tracing.span("tgp.model.pool") as sp:
                    out: PoolingOutput = pooler(batch.with_features(x))
                    if sp:
                        sp.set(level=level, slots=out.graph.num_nodes)
                outs.append(out)
                batch = out.graph
                x = batch.x
                with tracing.span("tgp.model.readout") as sp:
                    if sp:
                        sp.set(level=level)
                    r = torch.cat([global_reduce(
                        x.to(torch.float32), op=op,
                        node_graph=batch.node_graph,
                        num_graphs=batch.num_graphs,
                        node_mask=batch.node_mask)
                        for op in self.readout_ops], dim=1)
                    z = r if z is None else z + r
            with tracing.span("tgp.model.head"):
                for lin in self.head[:-1]:
                    z = F.relu(lin(z))
                logits = self.head[-1](z)
        return logits, outs
