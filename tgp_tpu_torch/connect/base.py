"""Sparse connect: the pooled adjacency from the original connectivity
(port of ``sparse_connect`` in ``tgp_tpu/connect/base.py``).

Partial selection (top-k): ``A' = A[kept, kept]``, relabelled to supernode
ids by masking, not compaction.  Total assignment: both endpoints
relabelled, duplicates merged by :func:`~tgp_tpu_torch.ops.sparse.coalesce`
in a fixed order, receiver-major: the pooled edges ascend by receiver (JAX
emits the same set sender-major), so the post-pool ``GCNConv`` can take
its sorted branch.
Batched dense ``S [B, N, K]``: ``SᵀAS`` by two batched products
(:func:`dense_connect`).  Unbatched dense ``S [N, K]``: per graph
``S_gᵀ A_g S_g`` without densifying ``A`` (:func:`dense_connect_unbatched`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from tgp_tpu_torch.ops.segment import dense_rows
from tgp_tpu_torch.ops.sparse import (check_and_filter_edge_weights,
                                      coalesce, postprocess_adj_sparse, spmm)
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["ConnectConfig", "PooledEdges", "sparse_connect",
           "dense_connect", "dense_connect_unbatched"]


@dataclass(frozen=True)
class ConnectConfig:
    """Post-processing flags shared by connectors."""

    reduce_op: str = "sum"
    remove_self_loops: bool = True
    degree_norm: bool = False
    edge_weight_norm: bool = False
    prune_eps: Optional[float] = None


class PooledEdges(NamedTuple):
    """Pooled sparse connectivity, with the layout its merge made:
    ``edges_sorted`` when the edges ascend by receiver."""

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_weight: torch.Tensor
    edge_mask: torch.Tensor
    edges_sorted: bool


def sparse_connect(senders, receivers, edge_weight, edge_mask,
                   so: SelectOutput,
                   cfg: ConnectConfig = ConnectConfig()) -> PooledEdges:
    """Pooled sparse connectivity over ``[0, num_clusters)``, same static
    edge budget; after a total assignment's merge the edges ascend by
    receiver (``edges_sorted``), a partial selection keeps the input's
    order with its dropped edges masked in place (unsorted)."""
    edge_weight = check_and_filter_edge_weights(edge_weight)
    s, r = senders.long(), receivers.long()
    sel = so.node_sel_mask
    valid = edge_mask & sel[s] & sel[r]
    w = torch.where(valid, edge_weight, 0.0)
    new_s = torch.where(valid, so.cluster_index[s], 0)
    new_r = torch.where(valid, so.cluster_index[r], 0)
    if not so.partial:
        new_s, new_r, w, valid = coalesce(new_s, new_r, w, valid,
                                          so.num_clusters,
                                          reduce=cfg.reduce_op)
    # the post-processing masks and reweighs in place: the layout holds
    return PooledEdges(*postprocess_adj_sparse(
        new_s, new_r, w, valid, so.cluster_graph, so.num_clusters,
        so.num_graphs, remove_self_loops_flag=cfg.remove_self_loops,
        degree_norm=cfg.degree_norm, edge_weight_norm=cfg.edge_weight_norm,
        prune_eps=cfg.prune_eps), edges_sorted=not so.partial)


def dense_connect(adj, s):
    """``A' = SᵀAS`` for batched dense ``adj [B, N, N]`` and ``s [B, N,
    K]``: ``[B, K, K]``, two batched products."""
    return torch.matmul(s.transpose(1, 2), torch.matmul(adj, s))


def dense_connect_unbatched(senders, receivers, edge_weight, s, node_graph,
                            num_graphs: int, node_mask=None, *, node_pos,
                            max_nodes: int):
    """Per-graph ``S_gᵀ A_g S_g`` (``[B, K, K]``) from the flat COO and an
    unbatched ``S [N, K]``: ``Z = A S`` by the port's :func:`~tgp_tpu_torch.
    ops.sparse.spmm` (``Z_i = Σ_{e: s_e = i} w_e S_{r_e}``, JAX's SpMM
    twin), then JAX's segment sum of the outer products ``S_i ⊗ Z_i`` as
    ``S_gᵀ Z_g`` over each graph's block (``node_pos``, ``max_nodes``)."""
    z = spmm(receivers, senders, edge_weight, s, s.shape[0])
    place = (node_graph, node_pos, num_graphs, max_nodes, node_mask)
    return torch.matmul(dense_rows(s, *place).transpose(1, 2),
                        dense_rows(z, *place))
