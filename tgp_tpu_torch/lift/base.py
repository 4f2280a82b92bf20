"""Lift (un-pooling) for sparse, batched dense and unbatched dense
assignments (port of ``tgp_tpu/lift/base.py``).

``matrix_op``: ``'precomputed'`` honours ``so.s_inv_op``; ``'transpose'``
gathers ``x̃_i = w_i · x'_{cluster(i)}``; ``'inverse'`` uses the closed-form
pseudo-inverse of a one-nonzero-per-row S, ``S⁺[c, i] = w_i / Σ_{j∈c} w_j²``.
With one entry per node, the reduce ops sum, mean and max coincide.

Batched dense ``S [B, N, K]`` (:func:`lift_dense_batched`): ``X̃ = S X'``
per graph (``S⁺ᵀ``, the transposed pseudo-inverse, for ``'inverse'``),
with ``reduce_op`` over the structural nonzeros of each row of ``S``.

Unbatched dense ``S [N, K]`` (:func:`lift_dense_unbatched`): each node
contracts its row of ``S`` (or of ``S⁺ᵀ = S (SᵀS)⁻¹`` per graph, JAX's
normal equations, for ``'inverse'``) with its graph's pooled block, as
one batched product per graph over the ``[B, max_nodes, ·]`` layout of
:func:`~tgp_tpu_torch.ops.segment.dense_rows`.
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.ops.segment import (dense_rows, gather_rows, node_cells,
                                       segment_sum)
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["lift_sparse", "lift_dense_batched", "lift_dense_unbatched",
           "base_lift"]


def _resolve_op(so: SelectOutput, matrix_op: str) -> str:
    if matrix_op == "precomputed":
        return so.s_inv_op
    if matrix_op in ("transpose", "inverse"):
        return matrix_op
    raise ValueError(f"matrix_op must be precomputed|transpose|inverse, "
                     f"got {matrix_op!r}")


def lift_sparse(x_pool: torch.Tensor, so: SelectOutput,
                matrix_op: str = "precomputed",
                reduce_op: str = "sum") -> torch.Tensor:
    """Gather pooled features ``x_pool [C, F]`` back to the nodes."""
    if reduce_op not in ("sum", "mean", "max"):
        raise ValueError(f"reduce_op must be sum|mean|max, got {reduce_op!r}")
    w = so.weight
    ci = so.cluster_index.long()
    C = so.num_clusters
    if _resolve_op(so, matrix_op) == "inverse":
        denom = segment_sum(torch.where(so.node_sel_mask, w * w, 0.0), ci, C)
        w = w / torch.clamp(gather_rows(denom, ci, C), min=1e-12)
    # the gathers' gradients add each cluster's rows in a fixed order
    out = gather_rows(x_pool, ci, C) * w[:, None]
    return torch.where(so.node_sel_mask[:, None], out, 0.0)


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``pinv`` with ``jnp.linalg.pinv``'s default cutoff (singular values
    below 10·max(m, n)·eps of the largest are dropped)."""
    eps = torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=10 * max(a.shape[-2:]) * eps)


def _pinv_s(s: torch.Tensor) -> torch.Tensor:
    """Per-graph pseudo-inverse of ``[..., N, K]`` assignments, transposed
    to stand in for ``S``."""
    return _pinv(s).transpose(-1, -2)


def _combine(s: torch.Tensor, x_block: torch.Tensor,
             reduce_op: str) -> torch.Tensor:
    """Per-node contributions ``s[..., n, k] · x_block[..., k, f]``
    combined over ``k`` by ``reduce_op`` (the structural nonzeros of
    ``s`` only)."""
    if reduce_op == "sum":
        return torch.matmul(s, x_block)
    nz = s != 0
    if reduce_op == "mean":
        cnt = torch.clamp(nz.sum(-1), min=1)
        return torch.matmul(s, x_block) / cnt[..., None].to(x_block.dtype)
    if reduce_op == "max":
        contrib = s[..., :, :, None] * x_block[..., None, :, :]
        contrib = torch.where(nz[..., :, :, None], contrib, -torch.inf)
        out = contrib.amax(-2)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"reduce_op must be sum|mean|max, got {reduce_op!r}")


def lift_dense_batched(x_pool: torch.Tensor, so: SelectOutput,
                       matrix_op: str = "precomputed",
                       reduce_op: str = "sum") -> torch.Tensor:
    """Batched ``S [B, N, K]`` over pooled ``[B, K, F]``: ``[B, N, F]``,
    zero on padded rows (``in_mask``)."""
    s = so.s
    if _resolve_op(so, matrix_op) == "inverse":
        s = _pinv_s(s)
    out = _combine(s, x_pool, reduce_op)
    if so.in_mask is not None:
        out = torch.where(so.in_mask[..., None], out, 0.0)
    return out


def lift_dense_unbatched(x_pool: torch.Tensor, so: SelectOutput,
                         matrix_op: str = "precomputed",
                         reduce_op: str = "sum") -> torch.Tensor:
    """Unbatched ``S [N, K]`` over pooled ``[B, K, F]`` (or ``[B·K, F]``):
    ``x̃_i = Σ_k s[i, k] x'[g(i), k]`` with ``reduce_op`` over the
    structural nonzeros of the row (``'mean'`` divides by their count,
    ``'max'`` takes the entrywise max of the terms)."""
    if reduce_op not in ("sum", "mean", "max"):
        raise ValueError(f"reduce_op must be sum|mean|max, got {reduce_op!r}")
    s = so.assignment
    K = s.shape[-1]
    if x_pool.dim() == 2:
        x_pool = x_pool.reshape(so.num_graphs, K, -1)
    # masked rows are left out: a padding node shares a real node's cell
    place = (so.node_graph, so.node_pos, so.num_graphs, so.max_nodes,
             so.node_mask)
    cells = node_cells(so.node_graph, so.node_pos, so.max_nodes)
    if _resolve_op(so, matrix_op) == "inverse":
        sd = dense_rows(s, *place)
        eye = torch.eye(K, dtype=s.dtype, device=s.device)
        inv = _pinv(torch.matmul(sd.transpose(1, 2), sd) + 1e-9 * eye)
        s = torch.matmul(sd, inv).reshape(
            -1, K).index_select(0, cells)
    if reduce_op == "max":
        contrib = s[:, :, None] * gather_rows(x_pool, so.node_graph,
                                              x_pool.shape[0])
        contrib = torch.where((s != 0)[:, :, None], contrib, -torch.inf)
        out = contrib.amax(1)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        out = torch.matmul(dense_rows(s, *place), x_pool).reshape(
            -1, x_pool.shape[-1]).index_select(0, cells)
        if reduce_op == "mean":
            cnt = torch.clamp((s != 0).sum(-1), min=1)
            out = out / cnt[:, None].to(out.dtype)
    if so.node_mask is not None:
        out = torch.where(so.node_mask[:, None], out, 0.0)
    return out


def base_lift(x_pool: torch.Tensor, so: SelectOutput,
              matrix_op: str = "precomputed",
              reduce_op: str = "sum") -> torch.Tensor:
    """Dispatching lift: sparse, unbatched or batched dense
    assignments."""
    if so.is_sparse:
        return lift_sparse(x_pool, so, matrix_op, reduce_op)
    if so.assignment is not None:
        return lift_dense_unbatched(x_pool, so, matrix_op, reduce_op)
    return lift_dense_batched(x_pool, so, matrix_op, reduce_op)
