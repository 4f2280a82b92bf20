"""Lift (un-pooling) for sparse and unbatched dense assignments (port of
``tgp_tpu/lift/base.py``, less the batched dense path).

``matrix_op``: ``'precomputed'`` honours ``so.s_inv_op``; ``'transpose'``
gathers ``x̃_i = w_i · x'_{cluster(i)}``; ``'inverse'`` uses the closed-form
pseudo-inverse of a one-nonzero-per-row S, ``S⁺[c, i] = w_i / Σ_{j∈c} w_j²``.
With one entry per node, the reduce ops sum, mean and max coincide.

Unbatched dense ``S [N, K]`` (:func:`lift_dense_unbatched`): each node
contracts its row of ``S`` (or of ``S⁺ᵀ = S (SᵀS)⁻¹`` per graph, JAX's
normal equations, for ``'inverse'``) with its graph's pooled block, as
one batched product per graph over the ``[B, max_nodes, ·]`` layout of
:func:`~tgp_tpu_torch.ops.segment.dense_rows`.
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.ops.segment import dense_rows, node_cells, segment_sum
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["lift_sparse", "lift_dense_unbatched", "base_lift"]


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
    if _resolve_op(so, matrix_op) == "inverse":
        denom = segment_sum(torch.where(so.node_sel_mask, w * w, 0.0), ci,
                            so.num_clusters)
        w = w / torch.clamp(denom[ci], min=1e-12)
    out = x_pool[ci] * w[:, None]
    return torch.where(so.node_sel_mask[:, None], out, 0.0)


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``pinv`` with ``jnp.linalg.pinv``'s default cutoff (singular values
    below 10·max(m, n)·eps of the largest are dropped)."""
    eps = torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=10 * max(a.shape[-2:]) * eps)


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
        contrib = s[:, :, None] * x_pool.index_select(
            0, so.node_graph.long())
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
    """Dispatching lift: sparse or unbatched dense assignments."""
    if so.assignment is not None:
        return lift_dense_unbatched(x_pool, so, matrix_op, reduce_op)
    return lift_sparse(x_pool, so, matrix_op, reduce_op)
