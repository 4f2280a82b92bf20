"""EigenPool lift (port of ``tgp_tpu/lift/eigenpool.py``): the inverse
mode-major reshape, then ``X̃ = Θ X'`` per graph — one batched product
over the ``[B, max_nodes, ·]`` layout (:func:`~tgp_tpu_torch.lift.base.
lift_dense_unbatched`), where JAX gathers an ``[N, H·K, F]`` block."""

from __future__ import annotations

import torch

from tgp_tpu_torch.lift.base import lift_dense_unbatched
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["eigenpool_lift"]


def eigenpool_lift(x_pool: torch.Tensor, so: SelectOutput) -> torch.Tensor:
    """``x_pool [B, K, H·F]`` → ``x̃ [N, F]`` over the flat node space
    (zero off ``node_mask``)."""
    H = so.num_modes
    B, K, HF = x_pool.shape
    F = HF // H
    raw = x_pool.reshape(B, K, H, F).transpose(1, 2).reshape(B, H * K, F)
    return lift_dense_unbatched(raw, so, matrix_op="transpose")
