"""EigenPool reduce (port of ``tgp_tpu/reduce/eigenpool.py``):
``X' = ΘᵀX`` per graph, reshaped mode-major ``[H·K, F] → [K, H·F]``.

JAX forms the ``[N, H·K, F]`` outer products and sums them per graph; the
port takes one batched product ``Θ_gᵀ X_g`` over the ``[B, max_nodes, ·]``
layout, as :func:`~tgp_tpu_torch.reduce.base.reduce_dense_unbatched`
does: the same sums, without the ``N·H·K·F`` intermediate.
"""

from __future__ import annotations

import torch

from tgp_tpu_torch.reduce.base import reduce_dense_unbatched
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["eigenpool_reduce"]


def eigenpool_reduce(x: torch.Tensor, so: SelectOutput) -> torch.Tensor:
    """``x [N, F]`` (flat over the batch) → ``[B, K, H·F]``; ``so`` holds
    Θ ``[N, H·K]`` in ``assignment`` and H in ``num_modes``."""
    H, K = so.num_modes, so.num_clusters
    raw = reduce_dense_unbatched(x, so.assignment, so.node_graph,
                                 so.num_graphs, so.node_mask,
                                 node_pos=so.node_pos,
                                 max_nodes=so.max_nodes)  # [B, H·K, F]
    B, _, F = raw.shape
    return raw.reshape(B, H, K, F).transpose(1, 2).reshape(B, K, H * F)
