"""Sharded sparse (score-and-keep) pooling driven by the port's own top-k
and SAG poolers (port of ``tgp_tpu/parallel/sparse_pool.py``).

:class:`TopkPoolModel` is the single-device reference and the owner of the
one set of parameters both forwards use: GCN → pooler → coarse ``(I +
A_pool)`` conv → masked sum readout → linear head.
:func:`make_sharded_topk_model_forward` returns its node-sharded twin on a
``DeviceMesh`` axis, which gives the same logits from the same modules:

* **GCN layer** — exact ``gcn_norm`` on the receiver-local degrees (edges
  are partitioned by receiver owner, so a row's degree is complete on its
  owner; K4 after the layout's sort), then this rank's sum on K1 over the
  partition's :class:`~tgp_tpu_torch.parallel.spmm.CsrLayout` with the
  normalised weights.  A node with a loop edge of its own keeps it and
  gets no unit loop, as ``add_remaining_self_loops`` has it (JAX's
  sharded body adds the unit loop to every node, so on a graph with
  loops it departs from its own single-device model);
* **score** — from the pooler's own parameters: ``TopkSelect.raw_scores``
  (row-wise) or ``SAGPooling.score``, whose ``GraphConv`` sees the
  gathered features and this rank's edges with their CSR layout (K1 in
  the kernel regime; the rows it owns are exact);
* **selection** — the gathered scores through the port's
  :func:`~tgp_tpu_torch.select.topk.topk_select_from_scores`, the same on
  every rank;
* **reduce** — the score-gated rows into the ``[K, H]`` supernode space
  (K4 after a stable sort), psummed;
* **connect and coarse conv** — JAX scatters every rank's relabelled
  edges into a dense ``[K, K]`` matrix and psums it before ``A_pool·m2``.
  The port computes the same function without the matrix: ``m2`` is
  replicated, so ``A_pool·m2 = Σ_d A_d·m2``; each rank sums its kept,
  relabelled edges into ``[K, H]`` on K1 (a ``CsrLayout`` made each
  call) and the ``[K, H]`` partials are psummed.  Supernode validity is an
  integer write, not a float max;
* **readout and head** — the sum over the valid supernodes, the head, the
  logits ``pmean``\\ ed.

Collectives and the gradient convention are :mod:`~tgp_tpu_torch.parallel.
_collectives`'; every float sum adds in a fixed order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import gcn_norm
from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.ops.sparse import spmm
from tgp_tpu_torch.parallel._collectives import (all_gather_rows,
                                                 group_rank, group_size,
                                                 pmean, psum)
from tgp_tpu_torch.parallel.spmm import CsrLayout, _LayoutCache
from tgp_tpu_torch.poolers.sag import SAGPooling
from tgp_tpu_torch.poolers.topk import TopkPooling
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.select import topk as topk_mod
from tgp_tpu_torch.select.topk import topk_budget
from tgp_tpu_torch.utils.activations import resolve_activation
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["TopkPoolModel", "make_sharded_topk_model_forward"]

Tensor = torch.Tensor

_EPS = 1e-12


class TopkPoolModel(nn.Module):
    """GCN → (Topk|SAG)Pooling → coarse ``(I + A_pool)`` conv → masked sum
    readout → linear head: the single-device reference forward, and the
    owner of the modules the sharded twin reuses.  ``lin1``, ``lin2`` and
    ``head`` are flax's ``Dense`` layers of the same names (initialised
    as they are, from ``generator``); ``in_channels`` is ``lin1``'s input
    width, which flax infers."""

    def __init__(self, pooler: nn.Module, hidden: int = 32,
                 num_classes: int = 3, *, in_channels: int,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pooler = pooler
        self.hidden = hidden
        self.num_classes = num_classes
        self.lin1 = lecun_normal_linear(in_channels, hidden,
                                        generator=generator)
        self.lin2 = lecun_normal_linear(hidden, hidden, generator=generator)
        self.head = lecun_normal_linear(hidden, num_classes,
                                        generator=generator)
        self.to(resolve_device(device))

    # ---- the row-wise pieces the sharded forward shares ------------------
    def pre_transform(self, x: Tensor) -> Tensor:
        return apply_linear(self.lin1, x)

    def coarse_transform(self, x: Tensor) -> Tensor:
        return apply_linear(self.lin2, x)

    def logits_head(self, z: Tensor) -> Tensor:
        return apply_linear(self.head, z)

    def pool_score(self, batch: GraphBatch) -> Tensor:
        """The activated selection score from the pooler's own
        parameters."""
        p = self.pooler
        if isinstance(p, SAGPooling):
            return p.score(batch)
        assert p.selector.min_score is None, (
            "sharded path supports the ratio top-k regime (min_score "
            "needs a per-graph softmax; use the single-device path)")
        return resolve_activation(p.selector.act)(
            p.selector.raw_scores(batch.x))

    # ---- the single-device reference forward -----------------------------
    def forward(self, batch: GraphBatch) -> Tensor:
        s, r, w = gcn_norm(batch, add_self_loops=True)
        h = spmm(s, r, w, self.pre_transform(batch.x), batch.num_nodes)
        h = torch.where(batch.node_mask[:, None], torch.relu(h), 0.0)

        pooled = self.pooler(batch.with_features(h)).graph
        m2 = self.coarse_transform(pooled.x)
        neigh = spmm(pooled.senders, pooled.receivers, pooled.edge_weight,
                     m2, pooled.num_nodes)
        h2 = torch.relu(m2 + neigh)
        z = global_reduce(h2, node_graph=pooled.node_graph,
                          num_graphs=pooled.num_graphs,
                          node_mask=pooled.node_mask, op="sum")
        return self.logits_head(z)


def _full_view(x_full: Tensor, mask_full: Tensor, n_pad: int,
               max_nodes: int, layout: Optional[CsrLayout] = None,
               w_d: Optional[Tensor] = None) -> GraphBatch:
    """A replicated single-graph view over the gathered node axis.  With
    ``layout`` (one rank's edges, receivers in global rows) and its
    weights ``w_d``, the edge slots hold that rank's edges in K1's two
    layouts: a one-hop scorer's rows owned by other ranks are then
    partial and must be sliced off."""
    dev = x_full.device
    common = dict(
        x=x_full,
        node_graph=torch.zeros(n_pad, dtype=torch.int32, device=dev),
        node_pos=torch.arange(n_pad, dtype=torch.int32, device=dev),
        node_mask=mask_full, num_graphs=1, max_nodes=max_nodes)
    if layout is None:
        zi = torch.zeros(1, dtype=torch.int32, device=dev)
        return GraphBatch(senders=zi, receivers=zi,
                          edge_weight=torch.zeros(1, dtype=x_full.dtype,
                                                  device=dev),
                          edge_mask=torch.zeros(1, dtype=torch.bool,
                                                device=dev), **common)
    w = w_d.to(torch.float32)
    w_s = w[layout.order]
    return GraphBatch(
        senders=layout.senders, receivers=layout.receivers, edge_weight=w_s,
        edge_mask=w_s != 0, edges_sorted=True, row_ptr=layout.row_ptr,
        senders_t=layout.senders_t, receivers_t=layout.receivers_t,
        edge_weight_t=w[layout.order_t], row_ptr_t=layout.row_ptr_t,
        **common)


def make_sharded_topk_model_forward(model: TopkPoolModel, mesh, *,
                                    rows_per: int, max_nodes: int,
                                    axis: str = "n"):
    """The node-sharded twin of ``model.forward`` on ``mesh``'s ``axis``:
    ``fn(x_loc [rows_per, F], m_loc [rows_per], S_d, R_d, W_d [E_loc])`` on
    every rank, with this rank's shards (``dense_pool.
    prepare_sharded_dense_graph`` layout: ``S`` global, ``R`` local, edges
    partitioned by receiver owner; :func:`~tgp_tpu_torch.parallel.
    dense_pool.device_put_sharded_dense`), returns the replicated logits
    ``[C]``, equal to the single-device ``model(flat_batch)[0]``.  The
    model holds the parameters (JAX's ``fn`` takes ``params`` first);
    their gradients are this rank's part, summed over the ranks by
    ``psum_grads_`` after ``backward_replicated``.

    ``max_nodes`` must equal the flat reference batch's ``max_nodes`` (the
    top-k budget ``Kmax = ceil(ratio · max_nodes)`` depends on it)."""
    pooler = model.pooler
    if isinstance(pooler, SAGPooling):
        assert pooler.user_gnn is False and pooler.gnn_kind == "graph_conv", (
            "sharded SAG supports the default one-hop graph_conv scorer "
            "(receiver-local aggregation); other scorers need their own "
            "sharding")
        assert pooler.min_score is None
        sag = True
    elif isinstance(pooler, TopkPooling):
        assert pooler.selector.min_score is None, (
            "sharded path supports the ratio top-k regime")
        sag = False
    else:
        raise NotImplementedError(
            f"sharded sparse pooling is implemented for TopkPooling / "
            f"SAGPooling, got {type(pooler).__name__}")
    assert not pooler.degree_norm and not pooler.edge_weight_norm, (
        "sharded connect implements the default postprocess "
        "(remove_self_loops only)")

    group = mesh.get_group(axis)
    n_pad = rows_per * group_size(group)
    row0 = group_rank(group) * rows_per
    kmax = topk_budget(pooler.ratio, max_nodes)  # one graph: K_total = kmax
    # the partition's layout (s_d → r_loc) and, for SAG's scorer, the same
    # edges into global rows (s_d → r_glob)
    layouts = _LayoutCache(lambda s, r: (
        CsrLayout(s, r, rows_per, n_pad),
        CsrLayout(s, r.to(torch.int64) + row0, n_pad, n_pad) if sag
        else None))

    def fn(x_loc, m_loc, s_d, r_d, w_d):
        layout, layout_g = layouts(s_d, r_d)
        r_glob = r_d.to(torch.int64) + row0
        s_l = s_d.to(torch.int64)

        # ---- GCN layer: exact gcn_norm, then K1 -------------------------
        # deg_i = Σ_{e: recv=i} |w_e| + 1 for the unit self loop, which a
        # valid node gets unless it has a loop edge of its own
        # (add_remaining_self_loops; a loop edge is receiver-local too)
        m1_loc = model.pre_transform(x_loc)
        m1_full = all_gather_rows(m1_loc, group)
        mask_full = all_gather_rows(m_loc.to(torch.uint8), group).bool()
        loops = ((s_l == r_glob) & (w_d != 0)).to(torch.int32)
        has_loop = torch.zeros(rows_per, dtype=torch.int32,
                               device=x_loc.device).index_add_(
            0, r_d.to(torch.int64), loops) > 0
        unit = (m_loc & ~has_loop).to(torch.float32)
        w_abs = w_d.abs().to(torch.float32)[layout.order]
        deg_loc = segment_sum(w_abs, layout.receivers, rows_per,
                              ids_sorted=True) + unit
        deg_full = all_gather_rows(deg_loc, group)
        dinv = torch.where(deg_full > _EPS,
                           torch.rsqrt(torch.clamp(deg_full, min=_EPS)), 0.0)
        wn = w_d * dinv[s_l] * dinv[r_glob]
        h_loc = layout.spmm(m1_full, wn)
        dinv_loc = dinv[row0:row0 + rows_per]
        h_loc = h_loc + m1_loc * (dinv_loc * dinv_loc * unit)[:, None]
        h_loc = torch.where(m_loc[:, None], torch.relu(h_loc), 0.0)
        h_full = all_gather_rows(h_loc, group)

        # ---- score with the pooler's own parameters ---------------------
        if sag:
            gview = _full_view(h_full, mask_full, n_pad, max_nodes,
                               layout_g, w_d)
            score_loc = model.pool_score(gview)[row0:row0 + rows_per]
        else:
            score_loc = model.pool_score(
                _full_view(h_loc, m_loc, rows_per, max_nodes))
        score_full = all_gather_rows(score_loc, group)

        # ---- selection: the library's, the same on every rank -----------
        so = topk_mod.topk_select_from_scores(
            score_full, _full_view(h_full, mask_full, n_pad, max_nodes),
            pooler.ratio, None, pooler.s_inv_op)

        # ---- reduce: score-gated rows into [K, H], psum -----------------
        ci_loc = so.cluster_index[row0:row0 + rows_per]
        keep = so.node_sel_mask[row0:row0 + rows_per]
        gate = (so.weight[row0:row0 + rows_per] * pooler.multiplier
                * keep)[:, None]
        x_pool = psum(segment_sum(h_loc * gate, ci_loc, kmax), group)

        # ---- connect: relabel this rank's edges; A_pool·m2 as Σ_d A_d·m2
        ci = so.cluster_index.to(torch.int64)
        sel = so.node_sel_mask
        cs, cr = ci[s_l], ci[r_glob]
        keep_e = sel[s_l] & sel[r_glob] & (w_d != 0)
        if pooler.remove_self_loops:
            keep_e = keep_e & (cs != cr)
        wp = torch.where(keep_e, w_d, 0.0)
        m2 = model.coarse_transform(x_pool)
        # receiver-major: row cr collects Σ w·m2[cs], as the reference's
        # coarse spmm(senders, receivers, …) aggregates onto receivers
        neigh = psum(CsrLayout(cs, cr, kmax, kmax).spmm(m2, wp), group)
        h2 = torch.relu(m2 + neigh)

        # ---- masked readout and head -------------------------------------
        slot = torch.where(sel, ci, kmax)
        cl_valid = torch.zeros(kmax + 1, dtype=torch.bool,
                               device=x_loc.device).index_put(
            (slot,), torch.ones_like(sel))[:kmax]
        z = torch.where(cl_valid[:, None], h2, 0.0).sum(0)
        logits = model.logits_head(z[None])[0]
        return pmean(logits, group)

    return fn
