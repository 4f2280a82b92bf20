"""Lift (un-pooling) for sparse assignments (port of the sparse path of
``tgp_tpu/lift/base.py``).

``matrix_op``: ``'precomputed'`` honours ``so.s_inv_op``; ``'transpose'``
gathers ``x̃_i = w_i · x'_{cluster(i)}``; ``'inverse'`` uses the closed-form
pseudo-inverse of a one-nonzero-per-row S, ``S⁺[c, i] = w_i / Σ_{j∈c} w_j²``.
With one entry per node, the reduce ops sum, mean and max coincide.
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["lift_sparse", "base_lift"]


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


def base_lift(x_pool: torch.Tensor, so: SelectOutput,
              matrix_op: str = "precomputed",
              reduce_op: str = "sum") -> torch.Tensor:
    """Dispatching lift (sparse assignments only in this port so far)."""
    return lift_sparse(x_pool, so, matrix_op, reduce_op)
