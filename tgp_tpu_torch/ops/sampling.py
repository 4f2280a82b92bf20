"""Negative edge sampling under static shapes (port of
``tgp_tpu/ops/sampling.py``; BNPool's sparse reconstruction loss).

One candidate negative pair is drawn per positive-edge slot (``E_neg =
E``), both endpoints uniform over the edge's own graph, then a fixed
number of rejection rounds (default 3) redraws the candidates that hit a
real edge or a self-loop; whatever still collides after the last round
is masked out.  The membership test is exact (sorted ``s·N + r`` keys)
for ``N ≤ 46340``, where the key fits int32 as in JAX; beyond that it is
the degree-windowed test with a 256-edge cap per sender.  Draws come from
an explicit ``torch.Generator`` (``torch.rand``), so a result is fixed
for a generator's state; JAX's key streams give other draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import segment_topk_rank

__all__ = ["negative_edge_sampling", "bipartite_negative_edge_sampling",
           "cap_samples_per_graph"]

Tensor = torch.Tensor

_EXACT_KEY_MAX_N = 46340  # floor(sqrt(2^31 - 1)): s·N + r fits in int32
_INT32_MAX = 2 ** 31 - 1


def _edge_key_table(senders, receivers, edge_mask, num_nodes: int):
    """Sorted keys ``s·N + r`` of the real edges (invalid → int32 max),
    int64 holding the int32 values."""
    key = torch.where(edge_mask,
                      senders.long() * num_nodes + receivers.long(),
                      _INT32_MAX)
    return torch.sort(key).values


def _is_edge_exact(table, s_q, r_q, num_nodes: int):
    q = s_q.long() * num_nodes + r_q.long()
    idx = torch.searchsorted(table, q).clamp(0, table.shape[0] - 1)
    return table[idx] == q


def _is_edge_windowed(senders, receivers, edge_mask, num_nodes, s_q, r_q,
                      cap: int = 256):
    """Membership test for huge graphs: binary search the sender's run
    and scan up to ``cap`` of its edges (a sender of larger degree may
    give false negatives, as in JAX)."""
    E = senders.shape[0]
    keyed = torch.where(edge_mask, senders.long(), num_nodes)
    # lexsort((receivers, keyed)): stable sorts from the least significant
    # key up
    order = torch.sort(receivers.long(), stable=True).indices
    order = order[torch.sort(keyed[order], stable=True).indices]
    rs, rr = keyed[order], receivers.long()[order]
    s_q, r_q = s_q.long(), r_q.long()
    lo = torch.searchsorted(rs, s_q, side="left")
    hi = torch.searchsorted(rs, s_q, side="right")
    offs = torch.arange(cap, device=senders.device)
    at = lo[..., None] + offs
    pos = at.clamp(0, E - 1)
    hit = ((rs[pos] == s_q[..., None]) & (rr[pos] == r_q[..., None])
           & (at < hi[..., None]))
    return hit.any(-1)


def _rejection_rounds(draw, collides, num_rounds: int):
    """Draw ``(src, dst)``, then ``num_rounds − 1`` times redraw the pairs
    that still collide: ``(src, dst, bad)``."""
    src, dst = draw()
    bad = collides(src, dst)
    for _ in range(1, num_rounds):
        s2, r2 = draw()
        src = torch.where(bad, s2, src)
        dst = torch.where(bad, r2, dst)
        bad = bad & collides(src, dst)
    return src, dst, bad


def negative_edge_sampling(
    batch: GraphBatch,
    generator: Optional[torch.Generator] = None,
    *,
    num_rounds: int = 3,
    force_undirected: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(neg_senders, neg_receivers, neg_mask)``, each ``[E]``, drawn
    from ``generator`` (on the batch's device; None: torch's default).

    Needs the collator's packed layout (valid nodes contiguous per graph,
    padding trailing), so a node uniform over graph ``g`` is ``start[g] +
    floor(u · n_g)``.  ``num_rounds`` rejection rounds keep the shape
    static; a collision survives them with probability ≈
    density^num_rounds."""
    E, N, dev = batch.num_edges, batch.num_nodes, batch.device
    n_g = batch.nodes_per_graph().long()
    start = torch.cumsum(n_g, 0) - n_g
    eg = batch.edge_graph.long()
    n_e = n_g[eg].clamp(min=1)

    if N <= _EXACT_KEY_MAX_N:
        table = _edge_key_table(batch.senders, batch.receivers,
                                batch.edge_mask, N)

        def hits(s, r):
            return _is_edge_exact(table, s, r, N)
    else:
        def hits(s, r):
            return _is_edge_windowed(batch.senders, batch.receivers,
                                     batch.edge_mask, N, s, r)

    def collides(s, r):
        hit = hits(s, r)
        if force_undirected:
            hit = hit | hits(r, s)
        return hit | (s == r)

    def draw():
        u1 = torch.rand(E, generator=generator, device=dev)
        u2 = torch.rand(E, generator=generator, device=dev)
        s = start[eg] + torch.floor(u1 * n_e).long()
        r = start[eg] + torch.floor(u2 * n_e).long()
        return s.clamp(0, N - 1), r.clamp(0, N - 1)

    src, dst, bad = _rejection_rounds(draw, collides, num_rounds)
    return src.to(torch.int32), dst.to(torch.int32), batch.edge_mask & ~bad


def bipartite_negative_edge_sampling(
    senders: Tensor,
    receivers: Tensor,
    edge_mask: Tensor,
    num_src: int,
    num_dst: int,
    generator: Optional[torch.Generator] = None,
    *,
    num_samples: Optional[int] = None,
    num_rounds: int = 3,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Bipartite variant: ``num_samples`` (default E) pairs uniform over
    ``[0, num_src) × [0, num_dst)``, collisions with real edges redrawn
    (self-loops are not excluded: the two node sets are distinct).  The
    exact key test while ``num_src · num_dst`` fits int32, else the
    windowed one."""
    E = senders.shape[0]
    S = num_samples if num_samples is not None else E
    dev = senders.device
    if num_src * num_dst <= _INT32_MAX:
        table = _edge_key_table(senders, receivers, edge_mask, num_dst)

        def collides(s, r):
            return _is_edge_exact(table, s, r, num_dst)
    else:
        def collides(s, r):
            return _is_edge_windowed(senders, receivers, edge_mask,
                                     num_src, s, r)

    def draw():
        s = torch.randint(0, num_src, (S,), generator=generator, device=dev)
        r = torch.randint(0, num_dst, (S,), generator=generator, device=dev)
        return s, r

    src, dst, bad = _rejection_rounds(draw, collides, num_rounds)
    return src.to(torch.int32), dst.to(torch.int32), ~bad


def cap_samples_per_graph(sample_mask: Tensor, sample_graph: Tensor,
                          num_graphs: int, cap: int) -> Tensor:
    """Keep at most ``cap`` valid samples per graph (static shape): the
    first valid ones in slot order."""
    n = sample_mask.shape[0]
    pos = segment_topk_rank(
        -torch.arange(n, dtype=torch.float32, device=sample_mask.device),
        sample_graph, num_graphs, mask=sample_mask)
    return sample_mask & (pos < cap)
