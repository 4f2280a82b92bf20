"""``SelectOutput`` (port of ``tgp_tpu/select/base.py``), sparse or dense.

* **sparse (hard or partial) assignments**: every node has a slot —
  ``cluster_index [N]`` (global supernode id), ``weight [N]`` and
  ``node_sel_mask [N]``, plus per-supernode ``cluster_graph``/
  ``cluster_pos`` over a static budget ``num_clusters``.
* **dense (soft) assignments**, batched: ``in_mask [B,N]`` for padded
  rows, ``s [B,N,K]`` and an optional ``cluster_mask [B,K]`` that
  overrides the supernode validity derived from ``s`` (the dense top-k
  layout stores signed score gates in ``s``).  The only dense producer is
  the top-k selection, whose ``extras`` (``idx``, ``gate``) hold ``s``
  compactly: ``s`` is built from them when read, since the pooling path
  reads ``extras`` and never needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from tgp_tpu_torch.ops.segment import segment_count

__all__ = ["SelectOutput"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class SelectOutput:
    """Output of a ``Select`` operator (sparse or dense layout)."""

    # --- sparse hard assignment ---
    cluster_index: Optional[Tensor] = None  # [N] int32, global supernode id
    weight: Optional[Tensor] = None  # [N]
    node_sel_mask: Optional[Tensor] = None  # [N] node is selected/assigned
    # --- carried batch structure ---
    node_graph: Optional[Tensor] = None  # [N]
    node_mask: Optional[Tensor] = None  # [N]
    cluster_graph: Optional[Tensor] = None  # [C] (sparse layout)
    cluster_pos: Optional[Tensor] = None  # [C] position within graph
    num_clusters: int = 0
    num_graphs: int = 1
    max_clusters: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)
    s_inv_op: str = "transpose"
    partial: bool = False
    # --- dense soft assignment ---
    in_mask: Optional[Tensor] = None  # [B,N]
    #: explicit supernode validity ([B,K] dense / [C] sparse)
    cluster_mask: Optional[Tensor] = None

    @property
    def is_dense(self) -> bool:
        return self.in_mask is not None

    @property
    def s(self) -> Optional[Tensor]:
        """Dense ``s [B,N,K]``: ``s[b, n, k] = gate[b, k] · 1[idx[b, k] =
        n]``, from the top-k ``extras``; None in the sparse layout."""
        if not self.is_dense:
            return None
        idx, gate = self.extras["idx"], self.extras["gate"]
        ar = torch.arange(self.in_mask.shape[1], dtype=idx.dtype,
                          device=idx.device)
        onehot = (idx[:, :, None] == ar[None, None, :]).to(gate.dtype)
        return (onehot * gate[:, :, None]).transpose(-1, -2)

    @property
    def is_sparse(self) -> bool:
        return self.cluster_index is not None

    @property
    def num_nodes(self) -> int:
        if self.is_sparse:
            return self.cluster_index.shape[0]
        return self.in_mask.shape[1]

    def out_mask(self) -> Tensor:
        """Supernode validity: ``cluster_mask`` when given; else ``[C]``
        bool (≥ 1 assigned node) in the sparse layout, ``[B,K]`` (positive
        column mass of ``s``) in the dense one."""
        if self.cluster_mask is not None:
            return self.cluster_mask
        if self.is_sparse:
            m = self.node_sel_mask if self.node_sel_mask is not None \
                else self.node_mask
            return segment_count(self.cluster_index, self.num_clusters,
                                 mask=m) > 0
        return self.s.sum(-2) > 0

    def replace(self, **kw) -> "SelectOutput":
        return dataclasses.replace(self, **kw)

    def with_extra(self, **kw) -> "SelectOutput":
        return self.replace(extras={**self.extras, **kw})
