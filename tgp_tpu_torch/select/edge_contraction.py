"""Edge-contraction selection (port of ``tgp_tpu/select/edge_contraction.py``;
Diehl 2019 / Landolfi 2022).

A learned edge score ``lin([x_s ‖ x_r])`` (softmax over each receiver's
edges, tanh or sigmoid, plus ``add_to_edge_score``), then a greedy maximal
matching in score order (Blelloch rounds): matched edges become 2-node
clusters rooted at their sender, the other nodes singletons.

The rounds are JAX's ``lax.while_loop`` as a host loop
(:func:`run_rounds`): the device is asked whether work is left every
:data:`CHECK_EVERY` rounds, since a round after convergence changes
nothing; the rounds that had work are counted on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import (gather_rows, node_cells, segment_min,
                                       segment_softmax, segment_sum)
from tgp_tpu_torch.ops.sparse import use_dense_vote
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.utils.linear import lecun_normal_linear

__all__ = ["maximal_matching", "maximal_matching_dense", "matching",
           "EdgeContractionSelect", "run_rounds", "rank_by", "dense_cells",
           "contract_matching"]

Tensor = torch.Tensor

#: rounds between two host reads of "is work left"
CHECK_EVERY = 4


def run_rounds(body: Callable, state, pending: Callable) -> Tuple[object,
                                                                   Tensor]:
    """``while pending(state): state = body(state)`` with a host read every
    :data:`CHECK_EVERY` rounds (``body`` must leave a converged state as
    it is).  Returns the final state and the number of rounds that had
    work, a 0-d int64 tensor on the device."""
    rounds = None
    while True:
        for _ in range(CHECK_EVERY):
            p = pending(state).to(torch.int64)
            rounds = p if rounds is None else rounds + p
            state = body(state)
        if not bool(pending(state)):
            return state, rounds


def rank_by(score: Tensor, valid: Tensor) -> Tensor:
    """``[n]`` int32 rank of each entry: valid ones first, by descending
    ``score``, ties by index — JAX's ``lexsort((-score, ~valid))`` as two
    stable sorts, the minor key first — scattered back as ``rank[order] =
    arange``."""
    order = torch.sort(-score.detach(), stable=True).indices
    order = order[torch.sort((~valid[order]).to(torch.int8),
                             stable=True).indices]
    n = score.shape[0]
    return torch.empty(n, dtype=torch.int32, device=score.device).scatter_(
        0, order, torch.arange(n, dtype=torch.int32, device=score.device))


def dense_cells(senders, receivers, node_graph, node_pos,
                max_nodes: int) -> Tensor:
    """``[E]`` int64 flat index ``g·Nmax² + pos(s)·Nmax + pos(r)`` of each
    edge's cell in the per-graph ``[B, Nmax, Nmax]`` matrix."""
    s, r = senders.long(), receivers.long()
    row = node_cells(node_graph, node_pos, max_nodes).index_select(0, s)
    return row * max_nodes + node_pos.long().index_select(0, r)


def matching(rank: Tensor, batch: GraphBatch, impl: str = "auto"):
    """Greedy maximal matching by edge ``rank``: ``"dense"`` (the per-graph
    ``[B, Nmax, Nmax]`` loop), ``"sparse"`` (scatters over the edge list)
    or ``"auto"`` (dense iff :func:`~tgp_tpu_torch.ops.sparse.
    use_dense_vote`).  Returns ``(match [E] bool, rounds)``."""
    if impl == "auto":
        impl = ("dense" if use_dense_vote(batch.num_graphs, batch.max_nodes)
                else "sparse")
    if impl == "dense":
        return maximal_matching_dense(
            rank, batch.senders, batch.receivers, batch.edge_mask,
            batch.node_graph, batch.node_pos, batch.num_graphs,
            batch.max_nodes)
    if impl == "sparse":
        return maximal_matching(rank, batch.senders, batch.receivers,
                                batch.edge_mask, batch.num_nodes)
    raise ValueError(f"unknown matching impl {impl!r}")


def maximal_matching(rank, senders, receivers, edge_mask, num_nodes: int):
    """Greedy maximal matching by edge ``rank`` (lower first): each round
    an active edge whose rank is the least at both its endpoints joins,
    and edges touching a matched node leave.  ``(match [E] bool, rounds)``."""
    E = rank.shape[0]
    big = torch.tensor(E + 1, dtype=torch.int32, device=rank.device)
    both = torch.cat([senders, receivers]).long()
    s, r = senders.long(), receivers.long()

    def body(state):
        match, active = state
        r_act = torch.where(active, rank, big)
        node_min = segment_min(torch.cat([r_act, r_act]), both, num_nodes)
        edge_min = torch.minimum(node_min.index_select(0, s),
                                 node_min.index_select(0, r))
        match = match | (active & (rank == edge_min))
        hit = torch.cat([match, match]).to(torch.int32)
        matched = segment_sum(hit, both, num_nodes) > 0
        active = active & ~matched.index_select(0, s) & ~matched.index_select(
            0, r)
        return match, active

    (match, _), rounds = run_rounds(
        body, (torch.zeros_like(edge_mask), edge_mask.clone()),
        lambda st: st[1].any())
    return match, rounds


def maximal_matching_dense(rank, senders, receivers, edge_mask, node_graph,
                           node_pos, num_graphs: int, max_nodes: int):
    """:func:`maximal_matching` on the per-graph ``[B, Nmax, Nmax]`` rank
    matrix (duplicate directed edges keep their least rank): each round is
    row and column reductions, no scatter.  A matched cell maps back to
    the edge holding its rank."""
    E = rank.shape[0]
    B, Nm = num_graphs, max_nodes
    big = E + 1
    cell = dense_cells(senders, receivers, node_graph, node_pos, Nm)
    r_e = torch.where(edge_mask, rank, big)
    D0 = torch.full((B * Nm * Nm,), big, dtype=torch.int32,
                    device=rank.device)
    D0.scatter_reduce_(0, cell, r_e, reduce="amin", include_self=True)
    D0 = D0.view(B, Nm, Nm)
    big_t = torch.tensor(big, dtype=torch.int32, device=rank.device)

    def body(state):
        match, active = state
        Da = torch.where(active, D0, big_t)
        node_min = torch.minimum(Da.amin(2), Da.amin(1))
        edge_min = torch.minimum(node_min[:, :, None], node_min[:, None, :])
        match = match | (active & (D0 == edge_min))
        matched = match.any(2) | match.any(1)
        active = active & ~matched[:, :, None] & ~matched[:, None, :]
        return match, active

    active0 = D0 < big
    (match_D, _), rounds = run_rounds(
        body, (torch.zeros_like(active0), active0), lambda st: st[1].any())
    return (match_D.view(-1).index_select(0, cell) & edge_mask
            & (D0.view(-1).index_select(0, cell) == r_e)), rounds


def contract_matching(match, senders, receivers, num_nodes: int,
                      root: str = "sender") -> Tensor:
    """``[N]`` int32 cluster of each node: itself, or for the non-root end
    of a matched edge the root end (``"sender"``, edge contraction;
    ``"min"``, the smaller node id, Graclus)."""
    s, r = senders.long(), receivers.long()
    if root == "sender":
        src, dst = s, r
    else:
        src, dst = torch.minimum(s, r), torch.maximum(s, r)
    cluster = torch.arange(num_nodes + 1, dtype=torch.int32, device=s.device)
    # matched edges share no node, so each target is written once; the
    # rest write 0 into the spare slot N
    idx = torch.where(match, dst, num_nodes)
    val = torch.where(match, src, 0).to(torch.int32)
    return cluster.scatter_(0, idx, val)[:num_nodes]


class EdgeContractionSelect(nn.Module):
    """Edge score + greedy maximal matching (port of JAX's
    ``EdgeContractionSelect``).

    ``in_channels`` is the feature width: JAX infers the scorer's width
    from the features (its ``in_channels`` only checks it), the port
    builds ``lin`` (``Linear(2·in_channels, 1)``, flax's ``lin``) from
    it.  The score of edge ``(s, r)`` is ``x_s·W_s + x_r·W_r + b``: the
    two halves of ``lin`` applied to the nodes and gathered, which is
    ``lin([x_s ‖ x_r])`` summed in another order without the ``[E, 2F]``
    concatenation.  ``edge_score_method``: ``"softmax"`` (over each
    receiver's edges), ``"tanh"`` or ``"sigmoid"``; then
    ``add_to_edge_score``.  ``dropout`` acts on the raw score in training
    mode, drawing from ``dropout_generator`` (None: torch's default).
    ``matching_impl``: see :func:`matching`.  ``extras``: the edge
    ``rank`` and the matching's ``rounds``."""

    def __init__(self, in_channels: int, edge_score_method: str = "softmax",
                 dropout: float = 0.0, add_to_edge_score: float = 0.5,
                 s_inv_op: str = "transpose", matching_impl: str = "auto",
                 *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if edge_score_method not in ("softmax", "tanh", "sigmoid"):
            raise ValueError(edge_score_method)
        self.in_channels = in_channels
        self.edge_score_method = edge_score_method
        self.dropout = dropout
        self.add_to_edge_score = add_to_edge_score
        self.s_inv_op = s_inv_op
        self.matching_impl = matching_impl
        self.dropout_generator = dropout_generator
        self.lin = lecun_normal_linear(2 * in_channels, 1,
                                       generator=generator)
        self.to(resolve_device(device))

    def edge_score(self, batch: GraphBatch) -> Tensor:
        """``[E]`` edge score, after normalization and the added constant."""
        x = batch.x
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"EdgeContractionSelect: in_channels={self.in_channels} but "
                f"features have width {x.shape[-1]}")
        ct = torch.promote_types(x.dtype, self.lin.weight.dtype)
        w = self.lin.weight.to(ct).view(2, self.in_channels).t()
        node = x.to(ct) @ w  # [N, 2]: each node's sender and receiver terms
        N = batch.num_nodes
        e = (gather_rows(node[:, 0], batch.senders, N)
             + gather_rows(node[:, 1], batch.receivers, N)
             + self.lin.bias.to(ct))
        if self.dropout > 0 and self.training:
            keep_p = 1.0 - self.dropout
            u = torch.rand(e.shape, generator=self.dropout_generator,
                           device=e.device)
            e = torch.where(u < keep_p, e / keep_p, 0.0)
        if self.edge_score_method == "softmax":
            # each receiver's normalizer summed in a fixed order
            e = segment_softmax(e, batch.receivers, batch.num_nodes,
                                mask=batch.edge_mask,
                                ids_sorted=batch.edges_sorted)
        elif self.edge_score_method == "tanh":
            e = torch.tanh(e)
        else:
            e = torch.sigmoid(e)
        return e + self.add_to_edge_score

    def forward(self, batch: GraphBatch) -> SelectOutput:
        N = batch.num_nodes
        e = self.edge_score(batch)
        rank = rank_by(e, batch.edge_mask)
        match, rounds = matching(rank, batch, self.matching_impl)
        cluster = contract_matching(match, batch.senders, batch.receivers, N)
        # a matched cluster weighs its edge's score, a singleton 1
        root = torch.where(match, batch.senders.long(), N)
        w_cluster = torch.ones(N + 1, dtype=e.dtype, device=e.device)
        w_cluster = w_cluster.scatter(0, root, torch.where(match, e, 0.0))
        weight = w_cluster[:N].index_select(0, cluster.long())
        return SelectOutput(
            cluster_index=cluster,
            weight=torch.where(batch.node_mask, weight, 0.0),
            node_sel_mask=batch.node_mask, node_graph=batch.node_graph,
            node_mask=batch.node_mask, cluster_graph=batch.node_graph,
            cluster_pos=batch.node_pos, num_clusters=N,
            num_graphs=batch.num_graphs, max_clusters=batch.max_nodes,
            partial=False, s_inv_op=self.s_inv_op,
            extras={"rank": rank, "match": match, "rounds": rounds})
