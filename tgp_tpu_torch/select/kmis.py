"""k-MIS selection (port of ``tgp_tpu/select/kmis.py``; Bacciu et al.
2023): a node score, a heuristic that divides it by its k-hop mass, a
greedy maximal k-independent set by the resulting rank (Blelloch rounds,
JAX's ``lax.while_loop`` as :func:`~tgp_tpu_torch.select.edge_contraction.
run_rounds`), and every node assigned to its least-rank MIS member within
k hops.  Supernode ids are the members' node ids (budget ``N``).

Two engines each for the MIS and the assignment: scatters over the edge
list (``"sparse"``) or the per-graph ``[B, Nmax, Nmax]`` boolean adjacency
(``"dense"``: reductions only), ``"auto"`` by
:func:`~tgp_tpu_torch.ops.sparse.use_dense_vote`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import (gather_rows, node_cells, segment_min,
                                       segment_sum)
from tgp_tpu_torch.ops.sparse import coalesce, use_dense_vote, weighted_degree
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.edge_contraction import (dense_cells, rank_by,
                                                   run_rounds)
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["maximal_independent_set", "maximal_independent_set_dense",
           "mis_cluster", "mis_cluster_dense", "KMISSelect", "index_hash"]

Tensor = torch.Tensor
INT_MAX = torch.iinfo(torch.int32).max


def _khop_min(vals, senders, receivers, edge_mask, num_nodes, k):
    """k rounds of min-propagation over the edges and self-loops."""
    s = senders.long()
    for _ in range(k):
        src = torch.where(edge_mask, vals.index_select(0, s), INT_MAX)
        vals = torch.minimum(segment_min(src, receivers, num_nodes), vals)
    return vals


def _khop_or(flags, senders, receivers, edge_mask, num_nodes, k):
    s = senders.long()
    for _ in range(k):
        src = (flags.index_select(0, s) & edge_mask).to(torch.int32)
        flags = flags | (segment_sum(src, receivers, num_nodes) > 0)
    return flags


def maximal_independent_set(rank, senders, receivers, edge_mask, node_mask,
                            order_k: int = 1):
    """Greedy maximal k-independent set by node ``rank`` (lower first):
    ``(mis [N] bool, rounds)``."""
    N = rank.shape[0]
    rank = torch.where(node_mask, rank, N)

    def body(state):
        mis, covered, min_rank = state
        mr = _khop_min(min_rank, senders, receivers, edge_mask, N, order_k)
        mis = mis | (node_mask & (rank == mr))
        covered = (_khop_or(mis, senders, receivers, edge_mask, N, order_k)
                   | ~node_mask | mis)
        return mis, covered, torch.where(covered, N, rank)

    (mis, _, _), rounds = run_rounds(
        body, (torch.zeros_like(node_mask), ~node_mask, rank),
        lambda st: ~st[1].all())
    return mis, rounds


def _rank_to_node(rank, min_rank, node_mask):
    """Node id of each least rank (ranks are a permutation of ``[0, N)``;
    ``N`` means none): unreached valid nodes map to themselves."""
    N = rank.shape[0]
    ar = torch.arange(N, dtype=torch.int32, device=rank.device)
    inv = torch.zeros(N + 1, dtype=torch.int32, device=rank.device)
    inv.scatter_(0, rank.long().clamp(0, N), ar)
    cluster = inv.index_select(0, min_rank.long().clamp(0, N))
    return torch.where((min_rank >= N) & node_mask, ar, cluster)


def mis_cluster(mis, rank, senders, receivers, edge_mask, node_mask,
                order_k: int = 1):
    """``[N]`` int32: each node's least-rank MIS member within k hops (its
    node id); unreached nodes map to themselves."""
    N = rank.shape[0]
    min_rank = torch.where(mis, rank, N)
    min_rank = _khop_min(min_rank, senders, receivers, edge_mask, N, order_k)
    return _rank_to_node(rank, min_rank, node_mask)


def _dense_adj(batch: GraphBatch) -> Tensor:
    """``[B, Nmax, Nmax]`` bool: a valid edge from row to column."""
    B, Nm = batch.num_graphs, batch.max_nodes
    A = torch.zeros(B * Nm * Nm, dtype=torch.uint8, device=batch.device)
    cells = dense_cells(batch.senders, batch.receivers, batch.node_graph,
                        batch.node_pos, Nm)
    A.scatter_reduce_(0, cells, batch.edge_mask.to(torch.uint8),
                      reduce="amax", include_self=True)
    return A.view(B, Nm, Nm).bool()


def _cells(batch: GraphBatch) -> Tensor:
    return node_cells(batch.node_graph, batch.node_pos, batch.max_nodes)


def _to_dense_min(vals, batch, big):
    """Packed → ``[B, Nmax]`` by min: padding rows share a cell with a
    real node, so they carry ``big`` and never win."""
    d = torch.full((batch.num_graphs * batch.max_nodes,), big,
                   dtype=vals.dtype, device=vals.device)
    d.scatter_reduce_(0, _cells(batch), vals, reduce="amin",
                      include_self=True)
    return d.view(batch.num_graphs, batch.max_nodes)


def _khop_min_dense(vals, A, k):
    for _ in range(k):
        vals = torch.minimum(torch.where(A, vals[:, :, None], INT_MAX).amin(1),
                             vals)
    return vals


def _khop_or_dense(flags, A, k):
    for _ in range(k):
        flags = flags | (A & flags[:, :, None]).any(1)
    return flags


def maximal_independent_set_dense(rank, batch: GraphBatch, order_k: int = 1):
    """:func:`maximal_independent_set` on the per-graph dense adjacency
    (packed in and out)."""
    N = rank.shape[0]
    nm = batch.node_mask
    A = _dense_adj(batch)
    cells = _cells(batch)
    rank_d = _to_dense_min(torch.where(nm, rank, N), batch, N)
    mask_d = torch.zeros(rank_d.numel(), dtype=torch.int32,
                         device=rank.device).scatter_reduce_(
        0, cells, nm.to(torch.int32), reduce="amax",
        include_self=True).view_as(rank_d).bool()

    def body(state):
        mis, covered, min_rank = state
        mr = _khop_min_dense(min_rank, A, order_k)
        mis = mis | (mask_d & (rank_d == mr))
        covered = _khop_or_dense(mis, A, order_k) | ~mask_d | mis
        return mis, covered, torch.where(covered, N, rank_d)

    (mis_d, _, _), rounds = run_rounds(
        body, (torch.zeros_like(mask_d), ~mask_d, rank_d),
        lambda st: ~st[1].all())
    return mis_d.view(-1).index_select(0, cells) & nm, rounds


def mis_cluster_dense(mis, rank, batch: GraphBatch, order_k: int = 1):
    """:func:`mis_cluster` on the per-graph dense adjacency."""
    N = rank.shape[0]
    nm = batch.node_mask
    A = _dense_adj(batch)
    mr_d = _to_dense_min(torch.where(mis & nm, rank, N), batch, N)
    min_rank = _khop_min_dense(mr_d, A, order_k).view(-1).index_select(
        0, _cells(batch))
    return _rank_to_node(rank, min_rank, nm)


def index_hash(n: int, device) -> Tensor:
    """JAX's unkeyed ``"random"`` scores, ``sin(i · 12.9898) · 43758.5453
    mod 1`` in f32 (``tgp_tpu/select/kmis.py:218``), by the same f32
    operations.  XLA's f32 ``sin`` and PyTorch's differ in the last bit
    for some arguments, which the product by 43758.5453 turns into
    different draws: the fallback is JAX's formula, not its bits."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    return torch.remainder(torch.sin(i * 12.9898) * 43758.5453, 1.0)


class KMISSelect(nn.Module):
    """Scorer + heuristic + k-MIS clustering (port of JAX's
    ``KMISSelect``).

    ``scorer``: ``"linear"`` (``sigmoid(lin(x))``; ``lin`` is built from
    ``in_channels``, which JAX infers from the features), ``"constant"``,
    ``"canonical"`` (``-i``), ``"degree"`` (weighted in-degree) or
    ``"random"`` (uniform draws from ``generator``, given to the pooler;
    without one, :func:`index_hash`).  ``score_heuristic``: None,
    ``"greedy"`` (divide by the k-hop node count) or any other
    value (by the k-hop score mass).  ``force_undirected`` adds the reversed
    edges and merges duplicates by max first.  ``mis_impl``: ``"auto"``,
    ``"dense"`` or ``"sparse"``.  ``extras``: ``mis``, the node ``rank``
    and the MIS loop's ``rounds``."""

    def __init__(self, in_channels: Optional[int] = None, order_k: int = 1,
                 scorer: str = "linear",
                 score_heuristic: Optional[str] = "greedy",
                 s_inv_op: str = "transpose", mis_impl: str = "auto",
                 force_undirected: bool = False, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 score_generator: Optional[torch.Generator] = None):
        super().__init__()
        if scorer not in ("linear", "constant", "canonical", "degree",
                          "random"):
            raise ValueError(f"unknown scorer {scorer!r}")
        self.order_k = order_k
        self.scorer = scorer
        self.score_heuristic = score_heuristic
        self.s_inv_op = s_inv_op
        self.mis_impl = mis_impl
        self.force_undirected = force_undirected
        self.score_generator = score_generator
        if scorer == "linear":
            if not in_channels:
                raise ValueError("the linear scorer needs in_channels")
            self.lin = lecun_normal_linear(in_channels, 1,
                                           generator=generator)
        self.to(resolve_device(device))

    def _score(self, batch: GraphBatch) -> Tensor:
        N, dev = batch.num_nodes, batch.device
        if self.scorer == "linear":
            return torch.sigmoid(apply_linear(self.lin, batch.x)[:, 0])
        if self.scorer == "constant":
            return torch.ones(N, device=dev)
        if self.scorer == "canonical":
            return -torch.arange(N, dtype=torch.float32, device=dev)
        if self.scorer == "degree":
            return weighted_degree(batch.receivers, batch.edge_weight, N,
                                   mask=batch.edge_mask)
        if self.score_generator is not None:
            return torch.rand(N, generator=self.score_generator, device=dev)
        return index_hash(N, dev)

    def _heuristic(self, score: Tensor, batch: GraphBatch) -> Tensor:
        if self.score_heuristic is None:
            return score
        k_sums = (torch.ones_like(score) if self.score_heuristic == "greedy"
                  else score)
        s = batch.senders.long()
        for _ in range(self.order_k):
            src = torch.where(batch.edge_mask,
                              gather_rows(k_sums, s, batch.num_nodes), 0.0)
            # each node's sum in a fixed order
            k_sums = k_sums + segment_sum(
                src, batch.receivers, batch.num_nodes,
                ids_sorted=batch.edges_sorted)
        return score / torch.clamp(k_sums, min=1e-12)

    def forward(self, batch: GraphBatch) -> SelectOutput:
        if self.force_undirected:
            s2 = torch.cat([batch.senders, batch.receivers])
            r2 = torch.cat([batch.receivers, batch.senders])
            w2 = torch.cat([batch.edge_weight, batch.edge_weight])
            m2 = torch.cat([batch.edge_mask, batch.edge_mask])
            s2, r2, w2, m2 = coalesce(s2, r2, w2, m2, batch.num_nodes,
                                      reduce="max")
            # the merged list ascends by receiver; no CSR layout
            batch = batch.replace(
                senders=s2, receivers=r2, edge_weight=w2, edge_mask=m2,
                edges_sorted=True, row_ptr=None, senders_t=None,
                receivers_t=None, edge_weight_t=None, row_ptr_t=None,
                in_degree=None, has_self_loop=None)
        score = self._score(batch)
        rank = rank_by(self._heuristic(score, batch), batch.node_mask)
        impl = self.mis_impl
        if impl == "auto":
            impl = ("dense" if use_dense_vote(batch.num_graphs,
                                              batch.max_nodes) else "sparse")
        if impl == "dense":
            mis, rounds = maximal_independent_set_dense(rank, batch,
                                                        self.order_k)
            cluster = mis_cluster_dense(mis, rank, batch, self.order_k)
        elif impl == "sparse":
            args = (batch.senders, batch.receivers, batch.edge_mask,
                    batch.node_mask, self.order_k)
            mis, rounds = maximal_independent_set(rank, *args)
            cluster = mis_cluster(mis, rank, *args)
        else:
            raise ValueError(f"unknown mis impl {impl!r}")
        return SelectOutput(
            cluster_index=cluster,
            weight=torch.where(batch.node_mask, score, 0.0),
            node_sel_mask=batch.node_mask, node_graph=batch.node_graph,
            node_mask=batch.node_mask, cluster_graph=batch.node_graph,
            cluster_pos=batch.node_pos, num_clusters=batch.num_nodes,
            num_graphs=batch.num_graphs, max_clusters=batch.max_nodes,
            partial=False, s_inv_op=self.s_inv_op,
            extras={"mis": mis, "rank": rank, "rounds": rounds})
