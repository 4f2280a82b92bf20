"""Graph-level readout (port of ``tgp_tpu/reduce/global_reduce.py``):
sparse ``[N,F]`` + ``node_graph`` or dense ``[B,N,F]`` + mask → ``[B,F]``."""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.ops.segment import (segment_max, segment_mean,
                                       segment_min, segment_sum)

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
        return segment_sum(x, node_graph, num_graphs, mask=node_mask)
    if op == "mean":
        return segment_mean(x, node_graph, num_graphs, mask=node_mask)
    if op == "max":
        out = segment_max(x, node_graph, num_graphs, mask=node_mask)
        return torch.where(torch.isfinite(out), out, 0.0)
    if op == "min":
        out = segment_min(x, node_graph, num_graphs, mask=node_mask)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown op {op!r}")
