"""Reduce ``X' = SᵀX`` for sparse assignments (port of the sparse path of
``tgp_tpu/reduce/base.py``)."""

from __future__ import annotations

import torch

from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["reduce_sparse", "base_reduce"]


def reduce_sparse(x: torch.Tensor, so: SelectOutput) -> torch.Tensor:
    """``x_pool[c] = Σ_{i: cluster(i)=c} w_i · x_i`` (``[C, F]``)."""
    src = x * so.weight[:, None]
    return segment_sum(src, so.cluster_index, so.num_clusters,
                       mask=so.node_sel_mask)


def base_reduce(x: torch.Tensor, so: SelectOutput) -> torch.Tensor:
    """Dispatching reduce (sparse assignments only in this port so far)."""
    return reduce_sparse(x, so)
