"""``SelectOutput`` for sparse (hard or partial) assignments (port of
``tgp_tpu/select/base.py``; the dense soft-assignment layout comes with
the dense regime).

Every node has a slot: ``cluster_index [N]`` (global supernode id),
``weight [N]`` and ``node_sel_mask [N]``, plus per-supernode
``cluster_graph``/``cluster_pos`` over a static budget ``num_clusters``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from tgp_tpu_torch.ops.segment import segment_count

__all__ = ["SelectOutput"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class SelectOutput:
    """Output of a sparse ``Select`` operator."""

    cluster_index: Tensor  # [N] int32, global supernode id
    weight: Tensor  # [N]
    node_sel_mask: Tensor  # [N] node is selected/assigned
    node_graph: Tensor  # [N]
    node_mask: Tensor  # [N]
    cluster_graph: Tensor  # [C]
    cluster_pos: Tensor  # [C] position within graph
    num_clusters: int
    num_graphs: int
    max_clusters: int
    extras: Dict[str, Any] = field(default_factory=dict)
    s_inv_op: str = "transpose"
    partial: bool = False

    @property
    def num_nodes(self) -> int:
        return self.cluster_index.shape[0]

    def out_mask(self) -> Tensor:
        """``[C]`` bool supernode validity (≥ 1 assigned node)."""
        return segment_count(self.cluster_index, self.num_clusters,
                             mask=self.node_sel_mask) > 0

    def replace(self, **kw) -> "SelectOutput":
        return dataclasses.replace(self, **kw)

    def with_extra(self, **kw) -> "SelectOutput":
        return self.replace(extras={**self.extras, **kw})
