"""Masked (in-place) sparse pooling for score-and-keep poolers (port of
``tgp_tpu/poolers/_masked.py``).

The pooled graph keeps the original node space: kept features are gated
by their score and ``node_mask`` shrinks to the kept set.  It reuses the
input's receiver-sorted layout and CSR metadata, so the post-pool GCN
stays on the CUDA kernel.  Per-slot values equal the compact path's (kept
node *i* lives at slot *i* instead of ``cluster_index[i]``).
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.sparse import spmm_route
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.src import PoolingOutput

__all__ = ["use_masked_pool", "masked_pool", "masked_lift"]


def use_masked_pool(pool_mode: str, batch: GraphBatch, *,
                    degree_norm: bool, edge_weight_norm: bool,
                    s_inv_op: str = "transpose") -> bool:
    """Resolve ``pool_mode`` ("compact" | "masked" | "auto").  Auto picks
    masked exactly where the post-pool conv runs the CSR kernel (sorted
    edges, CSR metadata, E ≥ PALLAS_MIN_EDGES, CUDA) and the masked path
    computes the same thing: no degree or weight normalization of the
    pooled adjacency, and a transpose lift (``masked_lift`` has no other).
    """
    if pool_mode == "compact":
        return False
    if pool_mode == "masked":
        return True
    if pool_mode != "auto":
        raise ValueError(f"pool_mode must be compact|masked|auto, got "
                         f"{pool_mode!r}")
    if degree_norm or edge_weight_norm or s_inv_op != "transpose":
        return False
    return spmm_route(batch) == "csr"


def masked_pool(batch: GraphBatch, so: SelectOutput, *,
                multiplier: float = 1.0,
                remove_self_loops: bool = True) -> PoolingOutput:
    """Gate + mask in the original node space (see module docstring)."""
    keep = so.node_sel_mask
    gate = torch.where(keep, so.weight * multiplier, 0.0)
    x_m = batch.x * gate[:, None].to(batch.x.dtype)
    w, m, w_t = batch.edge_weight, batch.edge_mask, batch.edge_weight_t
    has_loop = batch.has_self_loop
    if remove_self_loops:
        noloop = batch.senders != batch.receivers
        w = torch.where(noloop, w, 0.0)
        m = m & noloop
        if w_t is not None:
            w_t = torch.where(batch.senders_t != batch.receivers_t, w_t, 0.0)
        has_loop = torch.zeros_like(keep)
    pooled = batch.replace(
        x=x_m,
        node_mask=batch.node_mask & keep,
        edge_weight=w,
        edge_mask=m,
        edge_weight_t=w_t,
        in_degree=None,  # degrees must be recomputed under the mask
        node_mask_shrunk=True,  # edges outlive the mask
        has_self_loop=has_loop,
    )
    so = so.with_extra(pool_mode="masked")
    return PoolingOutput(so=so, graph=pooled)


def masked_lift(x_pool: torch.Tensor, so: SelectOutput,
                s_inv_op: str) -> torch.Tensor:
    """Node-space lift: a weight-gated identity."""
    if s_inv_op != "transpose":
        raise NotImplementedError(
            "masked pool_mode implements lift for s_inv_op='transpose' only")
    gate = torch.where(so.node_sel_mask, so.weight, 0.0)
    return x_pool * gate[:, None].to(x_pool.dtype)
