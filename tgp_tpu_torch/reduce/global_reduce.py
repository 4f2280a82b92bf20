"""Graph-level readout (port of ``tgp_tpu/reduce/global_reduce.py``):
sparse ``[N,F]`` + ``node_graph`` or dense ``[B,N,F]`` + mask → ``[B,F]``.

The sparse ``sum`` and ``mean`` add in a fixed order, as
``jax.ops.segment_sum`` does, by :func:`~tgp_tpu_torch.ops.segment.
segment_sum_ordered`: a stable sort of the (clipped) graph ids gives the
rows' graph order, and K4's ``gather_segment_sum`` sums each graph's run
of rows from per-graph offsets, reading the rows through that order and
skipping masked ones (a CUDA kernel on the card, its plain version on the
CPU; no sorted, masked copy of the rows is written).  Every
batch type takes this one route: the
batches of ``from_graphs`` (padding nodes in the last graph), masked pooling
(which keeps them) and compact pooling (``cluster_graph = arange // kmax``)
all hold ascending ids, whose stable sort is the identity; any other ids
are sorted first and give JAX's answer too.  ``max``/``min`` stay on a
scatter (exact in any order)."""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.ops.segment import (segment_count, segment_max,
                                       segment_min, segment_sum_ordered)

__all__ = ["global_reduce"]

Tensor = torch.Tensor


def global_reduce(x: Tensor, *, node_graph: Optional[Tensor] = None,
                  num_graphs: Optional[int] = None,
                  node_mask: Optional[Tensor] = None,
                  mask: Optional[Tensor] = None, op: str = "sum") -> Tensor:
    """Readout.  Sparse mode: ``x [N,F]`` with ``node_graph``/``node_mask``.
    Dense mode: ``x [B,N,F]`` with ``mask [B,N]``.  Empty graphs read 0
    under max/min."""
    if x.dim() == 3:
        m = (mask[..., None] if mask is not None
             else torch.ones_like(x[..., :1], dtype=torch.bool))
        if op == "sum":
            return torch.where(m, x, 0.0).sum(1)
        if op == "mean":
            return (torch.where(m, x, 0.0).sum(1)
                    / torch.clamp(m.sum(1), min=1).to(x.dtype))
        if op == "max":
            out = torch.where(m, x, -torch.inf).amax(1)
            return torch.where(torch.isfinite(out), out, 0.0)
        if op == "min":
            out = torch.where(m, x, torch.inf).amin(1)
            return torch.where(torch.isfinite(out), out, 0.0)
        raise ValueError(f"unknown op {op!r}")
    if node_mask is None:
        node_mask = mask
    if op == "sum":
        return segment_sum_ordered(x, node_graph, num_graphs, node_mask)
    if op == "mean":
        s = segment_sum_ordered(x, node_graph, num_graphs, node_mask)
        c = segment_count(node_graph, num_graphs, mask=node_mask).to(s.dtype)
        c = torch.clamp(c, min=1e-12)
        return s / c.reshape(c.shape + (1,) * (s.dim() - 1))
    if op == "max":
        out = segment_max(x, node_graph, num_graphs, mask=node_mask)
        return torch.where(torch.isfinite(out), out, 0.0)
    if op == "min":
        out = segment_min(x, node_graph, num_graphs, mask=node_mask)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown op {op!r}")
