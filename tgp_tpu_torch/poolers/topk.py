"""Top-k pooling (port of ``tgp_tpu/poolers/topk.py``).

Sparse batch: TopkSelect → reduce → sparse connect → lift, or the masked
in-place layout (:mod:`tgp_tpu_torch.poolers._masked`).  Dense batch: the
scatter-free fast path — a per-graph top-k (:func:`~tgp_tpu_torch.select.
topk.dense_topk_indices`), then :func:`dense_topk_apply` pools features and
adjacency with one-hot products or gathers.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import ConnectConfig
from tgp_tpu_torch.graph import DenseGraphBatch
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.poolers._masked import (masked_lift, masked_pool,
                                           use_masked_pool)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import TopkSelect, dense_topk_indices
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__all__ = ["TopkPooling", "dense_topk_pool", "dense_topk_apply",
           "gather_rows"]

Tensor = torch.Tensor


class _GatherRows(torch.autograd.Function):
    """``out[b, j] = x[b, idx[b, j]]``; top-k indices are unique per row,
    so the gradient is a permutation: an inverse position table and a
    gather of the cotangent (no scatter-add of ``[B, N, F]``)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, K, F = g.shape
        inv = torch.full((B, ctx.n), K, dtype=torch.int64, device=g.device)
        inv.scatter_(1, idx, torch.arange(K, device=g.device).expand(B, K))
        g_pad = torch.cat([g, g.new_zeros(B, 1, F)], dim=1)
        return torch.gather(g_pad, 1, inv[..., None].expand(-1, -1, F)), None


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x [B, N, F]`` rows at ``idx [B, K]`` (unique per row), with the
    permutation backward of ``tgp_tpu``'s ``gather_rows``."""
    return _GatherRows.apply(x, idx)


def dense_topk_apply(dense: DenseGraphBatch, idx: Tensor, slot_mask: Tensor,
                     gate: Tensor, multiplier: float = 1.0,
                     impl: str = "auto") -> DenseGraphBatch:
    """Apply a dense top-k selection (``idx``/``slot_mask``/``gate``
    ``[B, K]``): gate the kept features by their score and pool the
    adjacency to the kept-node subgraph, scatter-free.

    ``impl``: ``"onehot"`` builds the masked selection one-hot
    ``P [B, K, N]`` and pools with products (``P·A·Pᵀ``, ``P·X``), which
    return values exactly: one 0/1 term per output, and f32 products run
    without TF32; ``"gather"`` indexes the adjacency twice and gathers the
    features with :func:`gather_rows`; ``"auto"`` takes onehot for
    ``K ≤ 512``."""
    B, N, F = dense.x.shape
    K = idx.shape[1]
    if impl == "auto":
        impl = "onehot" if K <= 512 else "gather"
    scale = gate[:, :, None] * multiplier
    if impl == "onehot":
        ar = torch.arange(N, dtype=idx.dtype, device=idx.device)
        P = (idx[:, :, None] == ar[None, None, :]) & slot_mask[:, :, None]
        Pa = P.to(dense.adj.dtype)
        adj = torch.matmul(torch.matmul(Pa, dense.adj), Pa.transpose(-1, -2))
        x_sel = torch.matmul(P.to(dense.x.dtype), dense.x)
        x_pool = x_sel * scale.to(x_sel.dtype)
        return DenseGraphBatch(x=x_pool, adj=adj, mask=slot_mask)
    if impl != "gather":
        raise ValueError(f"unknown pool impl {impl!r}")
    x_sel = gather_rows(dense.x, idx)
    x_pool = x_sel * scale.to(x_sel.dtype)
    adj = torch.gather(dense.adj, 1, idx[:, :, None].expand(-1, -1, N))
    adj = torch.gather(adj, 2, idx[:, None, :].expand(-1, K, -1))
    m = slot_mask.to(adj.dtype)
    adj = adj * m[:, :, None] * m[:, None, :]
    return DenseGraphBatch(x=x_pool, adj=adj, mask=slot_mask)


def dense_topk_pool(dense: DenseGraphBatch, score: Tensor,
                    ratio: Union[int, float] = 0.5, multiplier: float = 1.0,
                    impl: str = "auto") -> DenseGraphBatch:
    """Dense top-k pooling from an activated ``score [B, N]``: rank, then
    :func:`dense_topk_apply`."""
    idx, slot_mask, gate = dense_topk_indices(score, dense.mask, ratio)
    return dense_topk_apply(dense, idx, slot_mask, gate, multiplier, impl)


class TopkPooling(SRCPooling):
    """Top-k pooling.  Pooled features are the kept nodes' features scaled
    by their score times ``multiplier``; the pooled adjacency is the
    kept-node subgraph.

    Sparse input, ``pool_mode``: ``"compact"`` relabels kept nodes into
    the ``[B·Kmax]`` supernode space; ``"masked"`` keeps the original node
    space (gated features, shrunk ``node_mask``); ``"auto"`` takes masked
    where the post-pool conv runs the CSR kernel (:func:`~tgp_tpu_torch.
    poolers._masked.use_masked_pool`), compact otherwise.  Dense input
    (a :class:`DenseGraphBatch`): the same selection with the same
    parameters, pooled by :func:`dense_topk_apply` (``pool_impl``) and
    post-processed like the sparse pooled adjacency."""

    IS_TRAINABLE = True
    ACCEPTS_DENSE_BATCH = True
    CAPTURABLE = True

    def __init__(self, in_channels: Optional[int] = None,
                 ratio: Union[int, float] = 0.5,
                 min_score: Optional[float] = None,
                 act: Union[str, Callable, None] = "tanh",
                 multiplier: float = 1.0, s_inv_op: str = "transpose",
                 connect_red_op: str = "sum", remove_self_loops: bool = True,
                 degree_norm: bool = False, edge_weight_norm: bool = False,
                 pool_mode: str = "auto", lift_op: str = "precomputed",
                 lift_red_op: str = "sum", *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.in_channels = in_channels
        self.ratio = ratio
        self.multiplier = multiplier
        self.s_inv_op = s_inv_op
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.pool_mode = pool_mode
        self.connect_cfg = ConnectConfig(
            reduce_op=connect_red_op, remove_self_loops=remove_self_loops,
            degree_norm=degree_norm, edge_weight_norm=edge_weight_norm)
        self.selector = TopkSelect(in_channels, ratio, min_score, act,
                                   s_inv_op, device=resolve_device(device),
                                   generator=generator)

    def forward(self, batch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None,
                pool_impl: str = "auto"):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = self.selector(batch)
        if isinstance(batch, DenseGraphBatch):
            pooled = dense_topk_apply(
                batch, so.extras["idx"], so.extras["slot_mask"],
                so.extras["gate"], multiplier=self.multiplier,
                impl=pool_impl)
            adj = postprocess_adj_dense(
                pooled.adj, remove_self_loops_flag=self.remove_self_loops,
                degree_norm=self.degree_norm,
                edge_weight_norm=self.edge_weight_norm)
            return PoolingOutput(so=so, dense=pooled.replace(adj=adj))
        if use_masked_pool(self.pool_mode, batch,
                           degree_norm=self.degree_norm,
                           edge_weight_norm=self.edge_weight_norm,
                           s_inv_op=self.s_inv_op):
            return masked_pool(batch, so, multiplier=self.multiplier,
                               remove_self_loops=self.remove_self_loops)
        x_pool = self.reduce(batch.x, so) * self.multiplier
        edges = self.connect(batch, so, self.connect_cfg)
        return PoolingOutput(so=so,
                             graph=self.pooled_graph(x_pool, edges, so, batch))

    def lift(self, x_pool: torch.Tensor, so: SelectOutput) -> torch.Tensor:
        if so.extras.get("pool_mode") == "masked":
            return masked_lift(x_pool, so, self.s_inv_op)
        return super().lift(x_pool, so)
