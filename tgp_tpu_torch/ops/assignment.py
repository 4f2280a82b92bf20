"""Total-assignment machinery (port of ``tgp_tpu/ops/assignment.py``):
upgrade a partial (top-k) selection to a full node → supernode assignment
by majority-vote propagation, with an in-graph fallback for nodes the
rounds do not reach.

Two engines give the same clusters: the sparse one counts the votes of a
round by two lexsorts over the edges (each a chain of stable sorts from
the least significant key up: torch has no lexsort) and the lengths of
the sorted runs (binary searches, no scatter), the dense one by one
batched one-hot product per round over the per-graph ``[B, Nmax, Nmax]``
vote matrix.  Every count is an exact integer, so neither depends on the
order of a sum.  The fallback is the first occupied supernode of the
node's graph, or with ``generator=`` a uniform pick among them (JAX's
``key=``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from tgp_tpu_torch.ops.segment import (segment_min, segment_sum,
                                       segment_topk_rank)
from tgp_tpu_torch.ops.sparse import use_dense_vote
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["propagate_assignments_step", "assign_all_nodes"]

Tensor = torch.Tensor


def _lexsort(keys) -> Tensor:
    """``numpy.lexsort(keys)``: the last key is the primary one; stable
    sorts from the first (least significant) key up."""
    order = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _run_heads(*cols) -> Tensor:
    """True at the first position of each run of equal rows of
    ``cols``."""
    head = torch.ones(cols[0].shape[0], dtype=torch.bool,
                      device=cols[0].device)
    diff = torch.zeros_like(head[1:])
    for c in cols:
        diff = diff | (c[1:] != c[:-1])
    head[1:] = diff
    return head


def _run_lengths(is_head: Tensor) -> Tensor:
    """The length of the run each position lies in (a run starts at each
    ``is_head``): the run ids ascend, so two binary searches give each
    run's bounds.  No scatter: a run of a million positions (the invalid
    votes' sentinel) costs no atomics."""
    run_id = torch.cumsum(is_head, 0)
    return (torch.searchsorted(run_id, run_id, right=True)
            - torch.searchsorted(run_id, run_id))


def propagate_assignments_step(cluster_index: Tensor, assigned: Tensor,
                               senders: Tensor, receivers: Tensor,
                               edge_mask: Tensor, num_clusters: int):
    """One propagation round: every unassigned node adopts the majority
    cluster among its *assigned* in-neighbours (ties → the smallest
    cluster id).  Returns the updated ``(cluster_index, assigned)``."""
    N = cluster_index.shape[0]
    s, r = senders.long(), receivers.long()
    votes = edge_mask & assigned[s] & ~assigned[r]
    dst = torch.where(votes, r, N)  # invalid → sentinel N
    c_vote = torch.where(votes, cluster_index.long()[s], num_clusters)

    # 1) group identical (dst, cluster) votes: sort, then count each run
    order = _lexsort((c_vote, dst))
    d_s, c_s = dst[order], c_vote[order]
    is_head = _run_heads(d_s, c_s)
    cnt = _run_lengths(is_head)

    # 2) per dst, the run of the largest count, then the smallest cluster
    head_valid = is_head & (d_s < N)
    order2 = _lexsort((c_s, -cnt, (~head_valid).to(torch.int64), d_s))
    d2, c2, v2 = d_s[order2], c_s[order2], head_valid[order2]
    best = _run_heads(d2) & v2

    # each real dst is best once; the rest write the dropped row N
    upd = torch.where(best, d2, N)
    pad_cluster = torch.cat([cluster_index.long(), cluster_index.new_zeros(
        1, dtype=torch.int64)]).index_put((upd,), torch.where(best, c2, 0))
    pad_assigned = torch.zeros(N + 1, dtype=torch.bool,
                               device=s.device).index_put((upd,), best)
    changed = pad_assigned[:N] & ~assigned
    new_cluster = torch.where(changed, pad_cluster[:N],
                              cluster_index.long()).to(cluster_index.dtype)
    return new_cluster, assigned | changed


def _scatter_max(shape, cells: Tensor, vals: Tensor) -> Tensor:
    """``zeros(shape).at[cells].max(vals)`` on a flat index (integers)."""
    out = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, cells, vals, "amax").view(shape)


def _propagate_assignments_dense(so: SelectOutput, senders: Tensor,
                                 receivers: Tensor, edge_mask: Tensor,
                                 node_pos: Tensor, max_nodes: int,
                                 max_iter: int):
    """``max_iter`` majority-vote rounds in the per-graph dense layout:
    a round counts ``counts[b, j, c] = Σ_i mult[b, i, j]·onehot(c_i)``
    with one batched product (f32 of exact integers), and its argmax (the
    first maximum) keeps the sparse engine's (max count, smallest id)
    tie-break, the clusters being ranked by ascending id within their
    graph.  ``mult`` counts duplicate directed edges.  Returns the
    updated ``(cluster_index, assigned)``."""
    C = so.num_clusters
    B, Nm, Km = so.num_graphs, max_nodes, so.max_clusters
    dev = senders.device
    ng = so.node_graph.long()
    pos = node_pos.long()
    s, r = senders.long(), receivers.long()

    # cluster ↔ its rank by ascending id within its graph (the tie-break)
    c_rank = segment_topk_rank(
        -torch.arange(C, dtype=torch.float32, device=dev),
        so.cluster_graph, B).clamp(0, Km - 1).long()
    table = _scatter_max((B, Km), so.cluster_graph.long() * Km + c_rank,
                         torch.arange(C, dtype=torch.int64, device=dev))

    # edge multiplicity as exact integer counts; padding edges add 0
    cell = (ng[s] * Nm + pos[s]) * Nm + pos[r]
    A = torch.zeros(B * Nm * Nm, dtype=torch.int32, device=dev).index_add_(
        0, cell, edge_mask.to(torch.int32)).view(B, Nm, Nm).to(torch.float32)
    # padding nodes alias cell [B-1, Nm-1]: they carry False/0 under max
    cells = ng * Nm + pos
    asg_d = _scatter_max((B, Nm), cells, so.node_sel_mask.to(torch.int64)) > 0
    cl0 = torch.where(so.node_sel_mask,
                      c_rank[so.cluster_index.long().clamp(0, C - 1)], 0)
    cl_d = _scatter_max((B, Nm), cells, cl0)

    for _ in range(max_iter):
        a = asg_d.to(torch.float32)
        valid = A * a[:, :, None] * (1.0 - a)[:, None, :]
        oh = F.one_hot(cl_d, Km).to(torch.float32) * a[..., None]
        counts = torch.matmul(valid.transpose(1, 2), oh)
        best_c = counts.argmax(-1)
        changed = (counts.amax(-1) > 0) & ~asg_d
        cl_d = torch.where(changed, best_c, cl_d)
        asg_d = asg_d | changed

    new_assigned = asg_d.view(-1)[cells] & so.node_mask
    global_c = table.view(-1)[ng * Km + cl_d.view(-1)[cells].clamp(0, Km - 1)]
    changed = new_assigned & ~so.node_sel_mask
    cluster_index = torch.where(changed, global_c.to(so.cluster_index.dtype),
                                so.cluster_index)
    return cluster_index, so.node_sel_mask | changed


def assign_all_nodes(so: SelectOutput, senders: Tensor, receivers: Tensor,
                     edge_mask: Tensor, *, max_iter: int = 5,
                     weight: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     node_pos: Optional[Tensor] = None,
                     max_nodes: Optional[int] = None,
                     impl: str = "auto") -> SelectOutput:
    """Upgrade a partial :class:`SelectOutput` to a total assignment.

    ``max_iter`` propagation rounds, then every valid node still
    unassigned goes to a supernode of its own graph: a uniformly random
    occupied one when ``generator`` is given, else the first (lowest-id)
    occupied one.  A graph whose selection occupies no supernode keeps its
    nodes unassigned.  ``weight`` replaces the per-node weight (None: ones
    on every assigned node).  ``impl``: ``"sparse"`` (per-round
    lexsorts), ``"dense"`` (per-round batched products; needs
    ``node_pos`` and ``max_nodes``) or ``"auto"`` (dense when the layout
    is given and :func:`~tgp_tpu_torch.ops.sparse.use_dense_vote`
    holds)."""
    if impl == "dense" and (node_pos is None or max_nodes is None):
        raise ValueError(
            "impl='dense' needs node_pos and max_nodes (the per-graph "
            "dense layout); pass them or use impl='sparse'/'auto'")
    use_dense = (node_pos is not None and max_nodes is not None
                 and impl != "sparse"
                 and (impl == "dense"
                      or use_dense_vote(so.num_graphs, max_nodes)))
    if use_dense:
        cluster_index, assigned = _propagate_assignments_dense(
            so, senders, receivers, edge_mask, node_pos, max_nodes,
            max_iter)
    else:
        cluster_index, assigned = so.cluster_index, so.node_sel_mask
        for _ in range(max_iter):
            cluster_index, assigned = propagate_assignments_step(
                cluster_index, assigned, senders, receivers, edge_mask,
                so.num_clusters)

    C, B = so.num_clusters, so.num_graphs
    dev = cluster_index.device
    occupied = segment_sum(torch.ones_like(cluster_index), cluster_index, C,
                           mask=assigned) > 0
    ones_c = torch.ones(C, dtype=torch.int32, device=dev)
    occ_count = segment_sum(ones_c, so.cluster_graph, B, mask=occupied)
    ng = so.node_graph.long()
    remaining = so.node_mask & ~assigned & (occ_count > 0)[ng]
    if generator is not None:
        # uniform over the graph's occupied supernodes: table[g, j] is the
        # graph's j-th occupied supernode by ascending id
        Kmax = so.max_clusters
        rank = segment_topk_rank(
            -torch.arange(C, dtype=torch.float32, device=dev),
            so.cluster_graph, B, mask=occupied).clamp(0, Kmax - 1).long()
        table = _scatter_max(
            (B, Kmax), so.cluster_graph.long() * Kmax + rank,
            torch.where(occupied, torch.arange(C, device=dev), 0))
        u = torch.rand(cluster_index.shape[0], generator=generator,
                       device=dev)
        j = torch.floor(u * occ_count[ng].clamp(min=1)).long()
        fallback = table.view(-1)[ng * Kmax + j.clamp(0, Kmax - 1)]
    else:
        first = segment_min(torch.arange(C, dtype=torch.int32, device=dev),
                            so.cluster_graph, B, mask=occupied)
        fallback = first.clamp(0, C - 1)[ng]
    cluster_index = torch.where(remaining, fallback.to(cluster_index.dtype),
                                cluster_index)
    assigned = assigned | remaining

    w = weight if weight is not None else torch.ones_like(so.weight)
    w = torch.where(assigned & so.node_mask, w, 0.0)
    return so.replace(cluster_index=cluster_index.to(torch.int32),
                      node_sel_mask=assigned & so.node_mask, weight=w,
                      partial=False)
