"""``SelectOutput`` (port of ``tgp_tpu/select/base.py``), sparse or dense.

* **sparse (hard or partial) assignments**: every node has a slot —
  ``cluster_index [N]`` (global supernode id), ``weight [N]`` and
  ``node_sel_mask [N]``, plus per-supernode ``cluster_graph``/
  ``cluster_pos`` over a static budget ``num_clusters``.
* **dense (soft) assignments**, batched: ``in_mask [B,N]`` for padded
  rows, ``s [B,N,K]`` and an optional ``cluster_mask [B,K]`` that
  overrides the supernode validity derived from ``s`` (the dense top-k
  layout stores signed score gates in ``s``).  A soft assignment (the
  dense cluster family's ``MLPSelect``) is held in ``batched_s``; the
  top-k selection's ``extras`` (``idx``, ``gate``) hold its ``s``
  compactly, built from them when read (its pooling path reads
  ``extras`` and never needs it).
* **unbatched dense assignments** (LaPool): ``assignment [N, K]`` over
  a multi-graph sparse batch, each node's row over its own graph's ``K``
  supernode slots; ``s`` returns it.  It also carries the batch's
  ``node_pos`` and ``max_nodes``, which the per-graph products of reduce,
  connect and lift read.  EigenPool's precoarsened levels hold their
  ``[N, H·K]`` operator Θ there, with ``num_modes`` H.

:func:`cluster_to_select_output` builds the sparse layout from a
cluster vector; :func:`compact_select_output` repacks a total
assignment into a per-graph budget.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
import sys
from typing import Any, Dict, Optional

import torch

from tgp_tpu_torch.ops.segment import (segment_count, segment_max,
                                       segment_sum, segment_topk_rank)

__all__ = ["SelectOutput", "cluster_to_select_output",
           "compact_select_output"]

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
    #: [N] position within the graph, and the batch's static bound on it
    #: (the unbatched dense layout's per-graph products read them)
    node_pos: Optional[Tensor] = None
    max_nodes: int = 0
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
    # --- unbatched dense soft assignment ---
    assignment: Optional[Tensor] = None  # [N,K]
    #: EigenPool's eigenvector modes H (its ``assignment`` is Θ, ``[N, H·K]``)
    num_modes: int = 0
    # --- batched dense soft assignment ---
    batched_s: Optional[Tensor] = None  # [B,N,K]

    @property
    def is_dense(self) -> bool:
        return (self.in_mask is not None or self.assignment is not None
                or self.batched_s is not None)

    @property
    def s(self) -> Optional[Tensor]:
        """Dense ``s``: the unbatched ``[N,K]`` assignment or the batched
        ``[B,N,K]`` soft one where there is one; else ``[B,N,K]`` with
        ``s[b, n, k] = gate[b, k] · 1[idx[b, k] = n]``, from the top-k
        ``extras``; None in the sparse layout."""
        if self.assignment is not None:
            return self.assignment
        if self.batched_s is not None:
            return self.batched_s
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
        if self.assignment is not None:
            return self.assignment.shape[0]
        return self.s.shape[1]

    def out_mask(self) -> Tensor:
        """Supernode validity: ``cluster_mask`` when given; else ``[C]``
        bool (≥ 1 assigned node) in the sparse layout, ``[B,K]`` (positive
        column mass of ``s``, summed per graph when unbatched) in the
        dense ones."""
        if self.cluster_mask is not None:
            return self.cluster_mask
        if self.is_sparse:
            m = self.node_sel_mask if self.node_sel_mask is not None \
                else self.node_mask
            return segment_count(self.cluster_index, self.num_clusters,
                                 mask=m) > 0
        if self.assignment is not None:
            return segment_sum(self.assignment, self.node_graph,
                               self.num_graphs, mask=self.node_mask) > 0
        return self.s.sum(-2) > 0

    def replace(self, **kw) -> "SelectOutput":
        return dataclasses.replace(self, **kw)

    def with_extra(self, **kw) -> "SelectOutput":
        return self.replace(extras={**self.extras, **kw})


def cluster_to_select_output(cluster_index: Tensor, batch, *,
                             weight: Optional[Tensor] = None,
                             node_sel_mask: Optional[Tensor] = None,
                             num_clusters: int, max_clusters: int,
                             cluster_graph: Optional[Tensor] = None,
                             partial: bool = False,
                             s_inv_op: str = "transpose",
                             extras: Optional[Dict[str, Any]] = None
                             ) -> SelectOutput:
    """A sparse :class:`SelectOutput` from a cluster vector (port of
    ``tgp_tpu.select.base.cluster_to_select_output``): ``cluster_index``
    maps each node to a supernode in ``[0, num_clusters)``; nodes outside
    ``node_sel_mask`` (default the batch's ``node_mask``) are masked.
    ``cluster_graph`` defaults to the largest graph id among a supernode's
    members (all equal), 0 for an empty one; ``cluster_pos`` ranks the
    occupied supernodes of a graph by id."""
    node_mask = batch.node_mask
    node_sel_mask = (node_mask if node_sel_mask is None
                     else node_sel_mask & node_mask)
    if weight is None:
        weight = torch.ones(cluster_index.shape[0], dtype=torch.float32,
                            device=cluster_index.device)
    weight = torch.where(node_sel_mask, weight, 0.0)
    ci = torch.where(node_sel_mask, cluster_index, 0).to(torch.int32)
    if cluster_graph is None:
        cg = segment_max(torch.where(node_sel_mask, batch.node_graph, -1),
                         ci, num_clusters)
        cluster_graph = cg.clamp(min=0).to(torch.int32)
    occupied = segment_count(ci, num_clusters, mask=node_sel_mask) > 0
    cluster_pos = segment_topk_rank(
        -torch.arange(num_clusters, dtype=torch.float32, device=ci.device),
        cluster_graph, batch.num_graphs, mask=occupied)
    return SelectOutput(
        cluster_index=ci, weight=weight, node_sel_mask=node_sel_mask,
        node_graph=batch.node_graph, node_mask=node_mask,
        cluster_graph=cluster_graph, cluster_pos=cluster_pos,
        num_clusters=num_clusters, num_graphs=batch.num_graphs,
        max_clusters=max_clusters, partial=partial, s_inv_op=s_inv_op,
        extras=dict(extras or {}))


def compact_select_output(so: SelectOutput, budget_per_graph: int, *,
                          check: bool = False) -> SelectOutput:
    """Repack a sparse total assignment into a graph-major budget (port of
    ``tgp_tpu.select.base.compact_select_output``): occupied supernodes
    are relabelled ``graph · budget + rank`` (rank among the graph's
    occupied supernodes, by old id), shrinking ``num_clusters`` from the
    node count to ``num_graphs · budget_per_graph``.

    A budget below a graph's occupied supernodes drops the overflow: those
    supernodes and their nodes are masked out, as in JAX.  The count of
    dropped supernodes is ``extras["overflow"]``, a 0-d tensor on the
    device (no host sync); ``check=True`` reads it and prints JAX's error
    line to stderr when it is nonzero (a host sync: for callers that ask,
    never on the serving path)."""
    if not so.is_sparse:
        raise ValueError("compact_select_output needs a sparse SelectOutput")
    C_old = so.num_clusters
    dev = so.cluster_index.device
    occupied = so.out_mask()
    slot = segment_topk_rank(
        -torch.arange(C_old, dtype=torch.float32, device=dev),
        so.cluster_graph, so.num_graphs, mask=occupied)
    ok = occupied & (slot < budget_per_graph)
    overflow = (occupied & ~ok).sum()
    if check and int(overflow):
        print(f"ERROR compact_select_output: budget_per_graph="
              f"{budget_per_graph} overflowed ({int(overflow)} supernodes "
              "dropped) — results are corrupt, raise the budget",
              file=sys.stderr)
    table_id = torch.where(ok, so.cluster_graph * budget_per_graph + slot,
                           0).to(torch.int32)
    ci = so.cluster_index.long()
    node_ok = so.node_sel_mask & ok[ci]
    ci_new = torch.where(node_ok, table_id[ci], 0).to(torch.int32)
    C_new = so.num_graphs * budget_per_graph
    ar = torch.arange(C_new, dtype=torch.int32, device=dev)
    return SelectOutput(
        cluster_index=ci_new, weight=torch.where(node_ok, so.weight, 0.0),
        node_sel_mask=node_ok, node_graph=so.node_graph,
        node_mask=so.node_mask, cluster_graph=ar // budget_per_graph,
        cluster_pos=ar % budget_per_graph, num_clusters=C_new,
        num_graphs=so.num_graphs, max_clusters=budget_per_graph,
        partial=so.partial, s_inv_op=so.s_inv_op,
        extras={**so.extras, "overflow": overflow})
