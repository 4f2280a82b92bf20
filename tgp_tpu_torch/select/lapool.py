"""LaPool selection (port of ``tgp_tpu/select/lapool.py``; Noutahi et al.
2019).

Leaders are the nodes whose Laplacian signal ``v = ‖(L X)_i‖₂`` is at least
every in-neighbour's (non-strict, so each graph's maximum leads); each
graph's leaders take slots ``[0, Kmax)`` (``Kmax = max_nodes``) in node
order.  Leaders are assigned one-hot to their slot, the other nodes by a
softmax over their cosine similarity to their graph's leaders: an
unbatched dense ``S [N, Kmax]``.  The optional shortest-path weights
(:func:`shortest_path_weights`) run on the host with scipy, as in JAX.

The cosines are JAX's ``einsum("nf,nkf->nk", xn, ln[graph])`` as one
product per graph over the ``[B, max_nodes, F]`` layout, so no
``[N, Kmax, F]`` tensor is made; the leader features and slots are
scattered by flat index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import (dense_rows, node_cells, segment_max,
                                       segment_topk_rank)
from tgp_tpu_torch.ops.sparse import spmm, weighted_degree
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["lapool_select", "shortest_path_weights"]

Tensor = torch.Tensor


def _safe_norm(x: Tensor, eps: float = 1e-24) -> Tensor:
    """L2 norm over the last axis (kept), with a finite gradient at 0."""
    return torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


def lapool_select(batch: GraphBatch, *, shortest_path_reg: bool = False,
                  sp_weight: Optional[Tensor] = None,
                  s_inv_op: str = "transpose") -> SelectOutput:
    """``sp_weight [N, Kmax]`` (from :func:`shortest_path_weights`)
    multiplies the followers' softmax.  ``extras``: ``leader``, ``v`` and
    ``slot``."""
    if shortest_path_reg and sp_weight is None:
        raise NotImplementedError(
            "shortest_path_reg needs host-computed sp_weight "
            "(see shortest_path_weights)")
    N, B, Kmax = batch.num_nodes, batch.num_graphs, batch.max_nodes
    x, nm = batch.x, batch.node_mask
    s, r = batch.senders, batch.receivers
    w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)

    # v = ‖(L X)_i‖₂ with L X = D X − A X, both over each node's out-edges
    deg = weighted_degree(s, w, N)
    lx = deg[:, None] * x - spmm(r, s, w, x, N)
    v = _safe_norm(lx)[:, 0]
    neigh_max = segment_max(v.index_select(0, s.long()), r, N,
                            mask=batch.edge_mask)
    leader = nm & (v >= neigh_max)

    slot = segment_topk_rank(
        -torch.arange(N, dtype=torch.float32, device=x.device),
        batch.node_graph, B, mask=leader).clamp(max=Kmax - 1)
    cell = node_cells(batch.node_graph, slot, Kmax)
    x_lead = x.new_zeros(B * Kmax, x.shape[1]).index_add(
        0, cell, torch.where(leader[:, None], x, 0.0)).view(B, Kmax, -1)
    slot_valid = torch.zeros(B * Kmax, dtype=torch.int32,
                             device=x.device).index_add_(
        0, cell, leader.to(torch.int32)).view(B, Kmax) > 0

    # cosine of each node to its own graph's leaders
    xn = x / _safe_norm(x)
    ln = x_lead / _safe_norm(x_lead)
    cos = torch.matmul(dense_rows(xn, batch.node_graph, batch.node_pos, B,
                                  batch.max_nodes, nm), ln.transpose(1, 2))
    cos = cos.reshape(-1, Kmax).index_select(
        0, node_cells(batch.node_graph, batch.node_pos, batch.max_nodes))
    valid_cols = slot_valid.index_select(0, batch.node_graph.long())
    # a row with no valid column gives zeros with finite gradients
    logits = torch.where(valid_cols, cos, torch.finfo(x.dtype).min)
    logits = logits - logits.amax(-1, keepdim=True).detach()
    e = torch.where(valid_cols, torch.exp(logits), 0.0)
    soft = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-20)
    if sp_weight is not None:
        soft = soft * sp_weight
    onehot = F.one_hot(slot.long(), Kmax).to(x.dtype) * leader[:, None]
    S = torch.where(leader[:, None], onehot, soft)
    S = torch.where(nm[:, None], S, 0.0)
    return SelectOutput(
        assignment=S, node_graph=batch.node_graph, node_mask=nm,
        node_pos=batch.node_pos, max_nodes=batch.max_nodes,
        num_clusters=Kmax, num_graphs=B, max_clusters=Kmax,
        s_inv_op=s_inv_op, extras={"leader": leader, "v": v, "slot": slot})


def shortest_path_weights(batch: GraphBatch, leader: Tensor,
                          slot: Tensor) -> Tensor:
    """β = 1 / hop distance from each leader to the nodes of its graph
    (0 for itself and for unreachable nodes), ``[N, Kmax]`` f32 on the
    batch's device; scipy ``csgraph`` on the host.  ``leader`` and
    ``slot`` come from a first :func:`lapool_select` pass."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    N, Kmax = batch.num_nodes, batch.max_nodes
    s = batch.senders.cpu().numpy()
    r = batch.receivers.cpu().numpy()
    em = batch.edge_mask.cpu().numpy()
    A = sp.csr_matrix((np.ones(em.sum()), (s[em], r[em])), shape=(N, N))
    slot_np = slot.cpu().numpy()
    ng = batch.node_graph.cpu().numpy()
    idx = np.nonzero(leader.cpu().numpy())[0]
    out = np.zeros((N, Kmax), np.float32)
    if idx.size:
        d = csgraph.shortest_path(A, method="D", unweighted=True,
                                  indices=idx)
        for row, i in enumerate(idx):
            dist = d[row]
            reach = np.isfinite(dist) & (dist > 0)
            w = np.where(reach, 1.0 / np.where(reach, dist, 1.0), 0.0)
            same = ng == ng[i]
            out[same, slot_np[i]] = w[same]
    return torch.from_numpy(out).to(batch.device)
