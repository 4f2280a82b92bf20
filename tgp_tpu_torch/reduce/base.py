"""Reduce ``X' = SᵀX`` (port of ``tgp_tpu/reduce/base.py``): sparse
assignments by a weighted segment sum, batched dense ``[B, N, K]``
assignments by one batched product, unbatched dense ``[N, K]`` assignments
by one batched product per graph.

The unbatched path computes JAX's segment sum of per-node ``K×F`` outer
products as ``S_gᵀ X_g``: the rows of ``S`` and ``X`` are scattered into
``[B, max_nodes, ·]`` by each node's ``(graph, position)``
(:func:`~tgp_tpu_torch.ops.segment.dense_rows`), so no ``[N, K, F]`` tensor is made.
"""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.ops.segment import dense_rows, segment_sum
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["reduce_sparse", "reduce_dense_batched", "reduce_dense_unbatched",
           "base_reduce"]

Tensor = torch.Tensor


def reduce_sparse(x: Tensor, so: SelectOutput) -> Tensor:
    """``x_pool[c] = Σ_{i: cluster(i)=c} w_i · x_i`` (``[C, F]``).  A total
    assignment's clusters may hold many nodes: their sums add in a fixed
    order (:func:`~tgp_tpu_torch.ops.segment.segment_sum`); a partial
    selection's supernodes hold one node each, so its rows are an indexed
    write (unselected nodes write to a spare row past the end)."""
    src = x * so.weight[:, None]
    if not so.partial:
        return segment_sum(src, so.cluster_index, so.num_clusters,
                           mask=so.node_sel_mask)
    C = so.num_clusters
    ci = so.cluster_index.long()
    row = torch.where(so.node_sel_mask & (ci >= 0) & (ci < C), ci, C)
    out = src.new_zeros((C + 1,) + src.shape[1:]).index_put((row,), src)
    return out[:C]


def reduce_dense_batched(x: Tensor, s: Tensor) -> Tensor:
    """``[B, N, K]ᵀ × [B, N, F] → [B, K, F]``."""
    return torch.matmul(s.transpose(1, 2), x)


def reduce_dense_unbatched(x: Tensor, s: Tensor, node_graph: Tensor,
                           num_graphs: int,
                           node_mask: Optional[Tensor] = None,
                           return_batched: bool = True, *, node_pos: Tensor,
                           max_nodes: int) -> Tensor:
    """``x_pool[g, k] = Σ_{i∈g} s[i, k] x[i]``: ``[B, K, F]``, or
    ``[B·K, F]`` with ``return_batched=False``.  ``node_pos`` and
    ``max_nodes`` (the batch's) place each node in its graph's block."""
    place = (node_graph, node_pos, num_graphs, max_nodes, node_mask)
    pooled = torch.matmul(dense_rows(s, *place).transpose(1, 2),
                          dense_rows(x, *place))
    return pooled if return_batched else pooled.reshape(-1, x.shape[-1])


def base_reduce(x: Tensor, so: SelectOutput, *,
                return_batched: bool = True) -> Tensor:
    """Dispatching reduce: sparse, unbatched or batched dense
    assignments."""
    if so.is_sparse:
        return reduce_sparse(x, so)
    if so.assignment is None:
        return reduce_dense_batched(x, so.s)
    return reduce_dense_unbatched(
        x, so.assignment, so.node_graph, so.num_graphs, so.node_mask,
        return_batched, node_pos=so.node_pos, max_nodes=so.max_nodes)
