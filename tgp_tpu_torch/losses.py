"""Auxiliary pooling losses (port of ``tgp_tpu/losses.py``): each loss in
a batched variant (dense ``S [B, N, K]``, ``adj [B, N, N]``) and, where
the reference has one, a sparse or unbatched twin on the packed flat
layout (``S [N, K]`` + ``node_graph`` + masked COO edges) that gives the
same scalar.

Every function takes and returns what its JAX twin does, under the same
name.  Padding conventions: padded rows of ``S`` are zero, padded edge
weights are zero.

Gradients stay finite on a batch with an empty padded graph.  Where the
JAX code takes a norm or a square root that can meet 0 there (a graph's
``SᵀS``, cluster sizes, column norms), the port takes it through
:func:`_safe_sqrt`: the same value, and a zero gradient at 0 where
``sqrt``'s would be infinite (``torch.where`` passes a NaN from the branch
it did not take, so the argument is made safe inside the root).
"""

from __future__ import annotations

import math

import torch

from tgp_tpu_torch.ops.segment import (gather_rows, segment_sum,
                                       segment_topk_rank)
from tgp_tpu_torch.ops.sparse import (check_and_filter_edge_weights,
                                      rank3_trace, spmm)

__all__ = [
    "mincut_loss",
    "sparse_mincut_loss",
    "sparse_ho_mincut_loss",
    "mincut_from_sums",
    "ho_mincut_from_motif",
    "link_pred_from_sums",
    "spectral_from_sums",
    "totvar_from_sums",
    "orthogonality_loss",
    "unbatched_orthogonality_loss",
    "hosc_orthogonality_loss",
    "unbatched_hosc_orthogonality_loss",
    "link_pred_loss",
    "sparse_link_pred_loss",
    "entropy_loss",
    "unbatched_entropy_loss",
    "totvar_loss",
    "sparse_totvar_loss",
    "asym_norm_loss",
    "unbatched_asym_norm_loss",
    "just_balance_loss",
    "unbatched_just_balance_loss",
    "spectral_loss",
    "sparse_spectral_loss",
    "cluster_loss",
    "unbatched_cluster_loss",
    "weighted_bce_reconstruction_loss",
    "sparse_bce_reconstruction_loss",
    "kl_loss",
    "beta_kl_divergence",
    "cluster_connectivity_prior_loss",
    "maxcut_loss",
]

Tensor = torch.Tensor

#: the JAX package's ``tgp_tpu.eps``
eps = 1e-8


def _batch_reduce(loss: Tensor, batch_reduction: str = "mean") -> Tensor:
    if batch_reduction == "mean":
        return loss.mean()
    if batch_reduction == "sum":
        return loss.sum()
    raise ValueError(
        f"batch_reduction must be 'mean' or 'sum', got {batch_reduction}")


def _safe_sqrt(x: Tensor) -> Tensor:
    """``sqrt(x)`` for ``x ≥ 0`` whose gradient at 0 is 0, not ∞·0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _fro(x: Tensor) -> Tensor:
    """Frobenius norm over the last two axes (finite gradient at 0)."""
    return _safe_sqrt((x * x).sum((-2, -1)))


def _nodes_per_graph(node_graph, num_graphs, node_mask):
    ones = torch.ones(node_graph.shape[0], dtype=torch.float32,
                      device=node_graph.device)
    return segment_sum(ones, node_graph, num_graphs, mask=node_mask)


# ---------------------------------------------------------------------------
# the shared "from sums" combinators
# ---------------------------------------------------------------------------


def mincut_from_sums(num, den):
    """``−num / (den + eps)``: per-graph ``Tr(SᵀAS)`` over ``Σ_n d_n‖S_n‖²``."""
    return -(num / (den + eps))


def ho_mincut_from_motif(S, motif_s, motif_deg, node_graph, num_graphs,
                         node_mask=None, batch_reduction="mean"):
    """Higher-order mincut from the applied motif operator ``motif_s =
    A³S`` and ``motif_deg = A³1``."""
    num = segment_sum((S * motif_s).sum(-1), node_graph, num_graphs,
                      mask=node_mask)
    den = segment_sum(motif_deg * (S * S).sum(-1), node_graph, num_graphs,
                      mask=node_mask)
    return _batch_reduce(mincut_from_sums(num, den), batch_reduction)


def link_pred_from_sums(sum_res, sum_ss, sts_fro_sq, nn_sum,
                        normalize_loss=True):
    """``sqrt(Σ_e(w_e−ss_e)² + Σ_g‖S_gᵀS_g‖²_F − Σ_e ss_e²)``, divided by
    ``Σ_g n_g²`` with ``normalize_loss``."""
    loss = _safe_sqrt(torch.clamp(sum_res + sts_fro_sq - sum_ss, min=0.0))
    if normalize_loss:
        loss = loss / torch.clamp(nn_sum, min=1.0)
    return loss


def spectral_from_sums(tr_ast, ca, m):
    """``−(Tr(SᵀAS) − ‖dᵀS‖²/2m) / 2m`` per graph, ``ca = dᵀS``."""
    safe_m = torch.clamp(m, min=eps)
    normalizer_tr = (ca * ca).sum(-1) / (2 * safe_m)
    return -(tr_ast - normalizer_tr) / (2 * safe_m)


def totvar_from_sums(weighted_l1, n_edges):
    """``Σ_e w_e|S_i−S_j|₁ / (2·E_g)``."""
    return weighted_l1 / (2 * torch.clamp(n_edges, min=1.0))


# ---------------------------------------------------------------------------
# MinCut
# ---------------------------------------------------------------------------


def mincut_loss(adj, S, adj_pooled, batch_reduction="mean"):
    """``−Tr(SᵀAS)/Tr(SᵀDS)`` per graph (MinCutPool)."""
    num = rank3_trace(adj_pooled)
    d_flat = adj.sum(-1)
    # Tr(Sᵀ D S) = Σ_n d_n ‖S_n‖²
    den = (d_flat * (S * S).sum(-1)).sum(-1)
    return _batch_reduce(-(num / (den + eps)), batch_reduction)


def sparse_mincut_loss(senders, receivers, edge_weight, S, node_graph,
                       num_graphs, node_mask=None, batch_reduction="mean"):
    """Sparse twin of :func:`mincut_loss`: edge-wise ``w·⟨S_i, S_j⟩``
    numerator, degree-weighted ``‖S_i‖²`` denominator."""
    edge_weight = check_and_filter_edge_weights(edge_weight)
    s, r = senders.long(), receivers.long()
    N = S.shape[0]
    degrees = segment_sum(edge_weight, s, N)
    den = segment_sum(degrees * (S * S).sum(-1), node_graph, num_graphs,
                      mask=node_mask)
    edge_contrib = edge_weight * (gather_rows(S, s, N)
                                  * gather_rows(S, r, N)).sum(-1)
    num = segment_sum(edge_contrib, node_graph[s], num_graphs)
    return _batch_reduce(mincut_from_sums(num, den), batch_reduction)


def sparse_ho_mincut_loss(senders, receivers, edge_weight, S, node_graph,
                          num_graphs, node_mask=None,
                          batch_reduction="mean"):
    """Higher-order mincut over ``M = A³`` by three SpMMs (never
    materialized)."""
    N = S.shape[0]
    Z = S
    d = torch.ones((N, 1), dtype=S.dtype, device=S.device)
    for _ in range(3):
        Z = spmm(receivers, senders, edge_weight, Z, N)
        d = spmm(receivers, senders, edge_weight, d, N)
    return ho_mincut_from_motif(S, Z, d[:, 0], node_graph, num_graphs,
                                node_mask=node_mask,
                                batch_reduction=batch_reduction)


# ---------------------------------------------------------------------------
# orthogonality
# ---------------------------------------------------------------------------


def _ortho_from_sts(STS: Tensor, batch_reduction: str) -> Tensor:
    """``‖SᵀS/‖SᵀS‖_F − I_K/√K‖_F`` per graph; ``max(‖SᵀS‖_F, eps)`` taken
    as ``sqrt(max(‖SᵀS‖²_F, eps²))`` (the same value, a finite gradient
    on an empty graph)."""
    sq = (STS * STS).sum((-2, -1), keepdim=True)
    STS_term = STS / torch.sqrt(torch.clamp(sq, min=eps * eps))
    k = STS.shape[-1]
    id_k = torch.eye(k, dtype=STS.dtype, device=STS.device) / math.sqrt(k)
    return _batch_reduce(_fro(STS_term - id_k), batch_reduction)


def orthogonality_loss(S, batch_reduction="mean"):
    """``‖SᵀS/‖SᵀS‖_F − I_K/√K‖_F`` (MinCutPool, DMoN)."""
    return _ortho_from_sts(torch.matmul(S.transpose(-1, -2), S),
                           batch_reduction)


def _per_graph_sts(S, node_graph, num_graphs, node_mask=None):
    """``[B, K, K]`` per-graph ``SᵀS`` (a segment sum of per-node outer
    products)."""
    outer = S[:, :, None] * S[:, None, :]
    return segment_sum(outer, node_graph, num_graphs, mask=node_mask)


def unbatched_orthogonality_loss(S, node_graph, num_graphs, node_mask=None,
                                 batch_reduction="mean"):
    return _ortho_from_sts(_per_graph_sts(S, node_graph, num_graphs,
                                          node_mask), batch_reduction)


def hosc_orthogonality_loss(S, mask=None, batch_reduction="mean"):
    B, num_nodes, K = S.shape
    if K <= 1:
        return _batch_reduce(S.new_zeros(B), batch_reduction)
    norm = _safe_sqrt((S * S).sum(-2)).sum(-1)
    sqrt_k = math.sqrt(K)
    if mask is not None:
        n_g = mask.sum(1).to(S.dtype)
        loss = ((sqrt_k - norm / torch.sqrt(torch.clamp(n_g, min=1.0)))
                / (sqrt_k - 1))
        # an all-masked (empty padded) graph contributes 0
        loss = torch.where(n_g > 0, loss, 0.0)
    else:
        loss = (sqrt_k - norm / math.sqrt(num_nodes)) / (sqrt_k - 1)
    return _batch_reduce(loss, batch_reduction)


def unbatched_hosc_orthogonality_loss(S, node_graph, num_graphs,
                                      node_mask=None,
                                      batch_reduction="mean"):
    K = S.shape[-1]
    if K <= 1:
        return S.new_zeros(())
    col_sq = segment_sum(S * S, node_graph, num_graphs, mask=node_mask)
    norm = _safe_sqrt(col_sq).sum(-1)
    n_g = _nodes_per_graph(node_graph, num_graphs, node_mask)
    sqrt_k = math.sqrt(K)
    loss = ((sqrt_k - norm / torch.sqrt(torch.clamp(n_g, min=1.0)))
            / (sqrt_k - 1))
    loss = torch.where(n_g > 0, loss, 0.0)
    return _batch_reduce(loss, batch_reduction)


# ---------------------------------------------------------------------------
# DiffPool: link prediction and entropy
# ---------------------------------------------------------------------------


def link_pred_loss(S, adj, normalize_loss=True, mask=None):
    """``‖A − SSᵀ‖_F`` over the whole batch, divided (``normalize_loss``)
    by the valid entries ``Σ_g n_g²`` with a ``mask``, else by
    ``adj.numel()``."""
    diff = adj - torch.matmul(S, S.transpose(-1, -2))
    if mask is not None:
        m = mask.to(S.dtype)
        diff = diff * m[:, :, None] * m[:, None, :]
    loss = _safe_sqrt((diff * diff).sum())
    if normalize_loss:
        if mask is not None:
            n_g = mask.to(S.dtype).sum(-1)
            loss = loss / torch.clamp((n_g * n_g).sum(), min=1.0)
        else:
            loss = loss / adj.numel()
    return loss


def sparse_link_pred_loss(S, senders, receivers, edge_weight, node_graph,
                          num_graphs, node_mask=None, normalize_loss=True):
    """Sparse twin: ``‖A−SSᵀ‖²_F = Σ_e (w_e−ss_e)² + Σ_g ‖S_gᵀS_g‖²_F −
    Σ_e ss_e²`` over the valid (nonzero-weight) edges."""
    edge_weight = check_and_filter_edge_weights(edge_weight)
    ss_ij = (S[senders.long()] * S[receivers.long()]).sum(-1)
    nz = (edge_weight != 0).to(S.dtype)
    sum_res = ((edge_weight - ss_ij) ** 2 * nz).sum()
    sum_ss = (ss_ij ** 2 * nz).sum()
    STS = _per_graph_sts(S, node_graph, num_graphs, node_mask)
    n_g = _nodes_per_graph(node_graph, num_graphs, node_mask)
    return link_pred_from_sums(sum_res, sum_ss, (STS * STS).sum(),
                               (n_g * n_g).sum(),
                               normalize_loss=normalize_loss)


def unbatched_entropy_loss(S, num_nodes=None, node_mask=None):
    """Mean per-node assignment entropy."""
    ent = -(S * torch.log(S + eps)).sum(-1)
    if node_mask is not None:
        ent = torch.where(node_mask, ent, 0.0)
        denom = torch.clamp(node_mask.sum(), min=1)
    else:
        denom = S.shape[0] if num_nodes is None else num_nodes
    return ent.sum() / denom


def entropy_loss(S, num_nodes=None, mask=None):
    """Batched entropy: the flattened unbatched entropy."""
    S2 = S.reshape(-1, S.shape[-1])
    m2 = mask.reshape(-1) if mask is not None else None
    return unbatched_entropy_loss(S2, num_nodes=num_nodes, node_mask=m2)


# ---------------------------------------------------------------------------
# total variation and the asymmetric norm (TVGNN, AsymCheegerCut)
# ---------------------------------------------------------------------------


def totvar_loss(S, adj, batch_reduction="mean"):
    """``Σ_ij a_ij |S_i − S_j|₁ / (2·E_g)`` per graph, as a dense masked
    contraction (zero entries add zero)."""
    l1 = (S[:, :, None, :] - S[:, None, :, :]).abs().sum(-1)
    loss = (adj * l1).sum((-2, -1))
    n_edges = (adj != 0).sum((-2, -1)).to(S.dtype)
    return _batch_reduce(loss / (2 * torch.clamp(n_edges, min=1.0)),
                         batch_reduction)


def sparse_totvar_loss(senders, receivers, edge_weight, S, node_graph,
                       num_graphs, batch_reduction="mean"):
    edge_weight = check_and_filter_edge_weights(edge_weight)
    s, r = senders.long(), receivers.long()
    N = S.shape[0]
    l1 = (gather_rows(S, s, N) - gather_rows(S, r, N)).abs().sum(-1)
    eg = node_graph[s]
    loss = segment_sum(edge_weight * l1, eg, num_graphs)
    n_edges = segment_sum((edge_weight != 0).to(S.dtype), eg, num_graphs)
    return _batch_reduce(totvar_from_sums(loss, n_edges), batch_reduction)


def _masked_col_quantile(S, k, node_graph, num_graphs, node_mask):
    """Per-(graph, column) value of rank ``floor(n_g / k)`` in descending
    order (ties by index, as :func:`~tgp_tpu_torch.ops.segment.
    segment_topk_rank` ranks them), over the flattened ``graph · K +
    column`` segments."""
    N, K = S.shape
    cols = torch.arange(K, device=S.device).expand(N, K)
    flat_seg = (node_graph.long()[:, None] * K + cols).reshape(-1)
    flat_vals = S.reshape(-1)
    flat_mask = (node_mask.repeat_interleave(K) if node_mask is not None
                 else None)
    rank = segment_topk_rank(flat_vals, flat_seg, num_graphs * K,
                             mask=flat_mask)
    n_g = _nodes_per_graph(node_graph, num_graphs, node_mask)
    idx = torch.minimum(torch.floor(n_g / k),
                        torch.clamp(n_g - 1, min=0)).to(torch.int32)
    target = idx[node_graph.long()][:, None].expand(N, K).reshape(-1)
    sel = rank == target
    if flat_mask is not None:
        sel = sel & flat_mask
    quant = segment_sum(torch.where(sel, flat_vals, 0.0), flat_seg,
                        num_graphs * K)
    return quant.reshape(num_graphs, K), n_g


def _asym(diff: Tensor, k) -> Tensor:
    return torch.where(diff >= 0, (k - 1) * diff, -diff)


def unbatched_asym_norm_loss(S, k, node_graph, num_graphs, node_mask=None,
                             batch_reduction="mean"):
    if k <= 1:
        return S.new_zeros(())
    quant, n_g = _masked_col_quantile(S, k, node_graph, num_graphs,
                                      node_mask)
    asym = _asym(S - gather_rows(quant, node_graph, num_graphs), k)
    if node_mask is not None:
        asym = torch.where(node_mask[:, None], asym, 0.0)
    inner = segment_sum(asym.sum(-1), node_graph, num_graphs,
                        mask=node_mask)
    beta = n_g * (k - 1)
    loss = (beta - inner) / torch.clamp(beta, min=1.0)
    return _batch_reduce(loss, batch_reduction)


def _sorted_desc(S: Tensor) -> Tensor:
    """``S`` sorted down the node axis, descending, as JAX's stable
    ascending sort reversed orders it (ties: the later node first)."""
    return torch.sort(S, dim=-2, stable=True).values.flip(-2)


def asym_norm_loss(S, k, mask=None, batch_reduction="mean"):
    """Batched ρ-quantile balance loss; with a mask, the per-graph
    (unbatched) semantics."""
    B, N, K = S.shape
    if k <= 1:
        return S.new_zeros(())
    if mask is None:
        idx = min(int(math.floor(N / k)), N - 1)
        quant = _sorted_desc(S)[:, idx, :]
        asym = _asym(S - quant[:, None, :], k)
        beta = N * (k - 1)
        return _batch_reduce((beta - asym.sum((-1, -2))) / beta,
                             batch_reduction)
    n_g = mask.sum(-1).to(S.dtype)
    s_sorted = _sorted_desc(torch.where(mask[..., None], S, -torch.inf))
    idx = torch.minimum(torch.floor(n_g / k),
                        torch.clamp(n_g - 1, min=0)).long()
    # row idx of each graph, picked by a mask (its gradient is a mask too,
    # where a gather's would be a scatter-add)
    pick = torch.arange(N, device=S.device)[None, :, None] == \
        idx[:, None, None]
    quant = torch.where(pick, s_sorted, 0.0).sum(1, keepdim=True)
    diff = torch.where(mask[..., None], S - quant, 0.0)
    asym = torch.where(mask[..., None], _asym(diff, k), 0.0)
    beta = n_g * (k - 1)
    return _batch_reduce((beta - asym.sum((-1, -2)))
                         / torch.clamp(beta, min=1.0), batch_reduction)


# ---------------------------------------------------------------------------
# JustBalance
# ---------------------------------------------------------------------------


def just_balance_loss(S, mask=None, normalize_loss=True,
                      batch_reduction="mean"):
    """``−Tr(√(SᵀS))`` with the elementwise ``sqrt(diag + eps)``."""
    K = S.shape[-1]
    diag = (S * S).sum(-2)  # [B, K] = diag(SᵀS)
    loss = -torch.sqrt(diag + eps).sum(-1)
    if normalize_loss:
        if mask is None:
            denom = math.sqrt(S.shape[-2] * K)
        else:
            denom = torch.sqrt(torch.clamp(mask.sum(-1).to(S.dtype) * K,
                                           min=1.0))
        loss = loss / denom
    return _batch_reduce(loss, batch_reduction)


def unbatched_just_balance_loss(S, node_graph, num_graphs, node_mask=None,
                                normalize_loss=True, batch_reduction="mean"):
    K = S.shape[-1]
    diag = segment_sum(S * S, node_graph, num_graphs, mask=node_mask)
    loss = -torch.sqrt(diag + eps).sum(-1)
    if normalize_loss:
        n_g = _nodes_per_graph(node_graph, num_graphs, node_mask)
        loss = loss / torch.sqrt(torch.clamp(n_g * K, min=1.0))
    return _batch_reduce(loss, batch_reduction)


# ---------------------------------------------------------------------------
# DMoN: spectral modularity and cluster size
# ---------------------------------------------------------------------------


def spectral_loss(adj, S, adj_pooled, mask=None, batch_reduction="mean"):
    B, N, K = S.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=S.device)
    degrees = adj.sum(-1) * mask
    m = degrees.sum(-1) / 2
    safe_m = torch.where(m > 0, m, 1.0)
    ca = (S * degrees[..., None]).sum(-2)  # dᵀS, [B, K]
    normalizer_tr = (ca * ca).sum(-1) / (2 * safe_m)
    loss = -(rank3_trace(adj_pooled) - normalizer_tr) / (2 * safe_m)
    loss = torch.where(m > 0, loss, 0.0)
    return _batch_reduce(loss, batch_reduction)


def sparse_spectral_loss(senders, receivers, edge_weight, S, node_graph,
                         num_graphs, node_mask=None, batch_reduction="mean"):
    edge_weight = check_and_filter_edge_weights(edge_weight)
    s, r = senders.long(), receivers.long()
    N = S.shape[0]
    degrees = segment_sum(edge_weight, s, N)
    eg = node_graph[s]
    edge_contrib = edge_weight * (gather_rows(S, s, N)
                                  * gather_rows(S, r, N)).sum(-1)
    tr_ast = segment_sum(edge_contrib, eg, num_graphs)
    m = segment_sum(edge_weight, eg, num_graphs) / 2
    ca = segment_sum(S * degrees[:, None], node_graph, num_graphs,
                     mask=node_mask)
    return _batch_reduce(spectral_from_sums(tr_ast, ca, m), batch_reduction)


def _cluster_from_sizes(cluster_size, n_g, K, batch_reduction):
    loss = (_safe_sqrt((cluster_size * cluster_size).sum(-1))
            / torch.clamp(n_g, min=1.0) * math.sqrt(K) - 1)
    return _batch_reduce(loss, batch_reduction)


def cluster_loss(S, mask=None, batch_reduction="mean"):
    B, N, K = S.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=S.device)
    return _cluster_from_sizes(S.sum(-2), mask.sum(-1).to(S.dtype), K,
                               batch_reduction)


def unbatched_cluster_loss(S, node_graph, num_graphs, node_mask=None,
                           batch_reduction="mean"):
    cluster_size = segment_sum(S, node_graph, num_graphs, mask=node_mask)
    n_g = _nodes_per_graph(node_graph, num_graphs, node_mask)
    return _cluster_from_sizes(cluster_size, n_g, S.shape[-1],
                               batch_reduction)


# ---------------------------------------------------------------------------
# BNPool: weighted BCE reconstruction, Beta KL, K-prior
# ---------------------------------------------------------------------------


def _bce_with_logits(logits, targets):
    # log(1 + exp(-|x|)) + max(x, 0) - x*y
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def weighted_bce_reconstruction_loss(rec_adj, adj, mask=None,
                                     balance_links=True,
                                     normalizing_const=None,
                                     batch_reduction="mean"):
    """Class-balanced BCE between reconstructed logits and the
    adjacency."""
    loss = _bce_with_logits(rec_adj, adj)
    edge_mask = adj != 0
    if mask is not None:
        edge_mask = edge_mask & mask[:, :, None] & mask[:, None, :]
        N = mask.sum(-1)
    else:
        N = torch.full((adj.shape[0],), adj.shape[-1], device=adj.device)
    if balance_links:
        n_edges = edge_mask.sum((-1, -2))
        n_not = torch.clamp(N * N - n_edges, min=1)
        balance = (n_not / torch.clamp(n_edges, min=1)).to(loss.dtype)
        loss = torch.where(edge_mask, loss * balance[:, None, None], loss)
    if mask is not None:
        m = mask.to(loss.dtype)
        loss = loss * m[:, :, None] * m[:, None, :]
    loss = loss.sum((-1, -2))
    if normalizing_const is not None:
        loss = loss / normalizing_const
    return _batch_reduce(loss, batch_reduction)


def sparse_bce_reconstruction_loss(link_logits, true_y, edges_graph=None,
                                   num_graphs=None, sample_mask=None,
                                   batch_reduction="mean"):
    """Per-sampled-edge BCE with a per-graph mean.  Returns ``(loss,
    per_graph_count)``."""
    rec = _bce_with_logits(link_logits, true_y)
    if edges_graph is None:
        if sample_mask is not None:
            cnt = torch.clamp(sample_mask.sum(), min=1)
            return torch.where(sample_mask, rec, 0.0).sum() / cnt, cnt
        return rec.mean(), torch.tensor(rec.shape[0])
    summed = segment_sum(rec, edges_graph, num_graphs, mask=sample_mask)
    cnt = segment_sum(torch.ones_like(rec), edges_graph, num_graphs,
                      mask=sample_mask)
    cnt = torch.clamp(cnt, min=1)
    return _batch_reduce(summed / cnt, batch_reduction), cnt


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def beta_kl_divergence(a_q, b_q, a_p, b_p):
    """Analytic ``KL(Beta(a_q, b_q) ‖ Beta(a_p, b_p))`` (BNPool's
    stick-breaking posterior against its prior)."""
    return (_betaln(a_p, b_p) - _betaln(a_q, b_q)
            + (a_q - a_p) * torch.digamma(a_q)
            + (b_q - b_p) * torch.digamma(b_q)
            + (a_p - a_q + b_p - b_q) * torch.digamma(a_q + b_q))


def kl_loss(kl_per_node, mask=None, node_graph=None, num_graphs=None,
            node_mask=None, normalizing_const=None, batch_reduction="mean"):
    """A per-node KL (already summed over its event axis) reduced to a
    scalar: masked sum over nodes (batched ``[B, N]``) or a segment sum
    (flat ``[N]`` + ``node_graph``, ``node_mask`` leaving the padding rows
    out)."""
    if mask is not None and node_graph is not None:
        raise ValueError("Cannot specify both mask and node_graph")
    if node_graph is not None:
        loss = segment_sum(kl_per_node, node_graph, num_graphs,
                           mask=node_mask)
    elif mask is not None:
        loss = torch.where(mask, kl_per_node, 0.0).sum(-1)
    else:
        loss = kl_per_node.sum(-1)
    if normalizing_const is not None:
        loss = loss / normalizing_const
    return _batch_reduce(loss, batch_reduction)


def cluster_connectivity_prior_loss(K, K_mu, K_var, normalizing_const=None,
                                    batch_reduction="mean"):
    prior = (0.5 * (K - K_mu) ** 2 / K_var).sum()
    if normalizing_const is not None:
        bs = normalizing_const.shape[0] if normalizing_const.dim() > 0 else 1
        prior = prior / bs / normalizing_const
    return _batch_reduce(prior, batch_reduction)


# ---------------------------------------------------------------------------
# MaxCut
# ---------------------------------------------------------------------------


def maxcut_loss(scores, senders, receivers, edge_weight, node_graph,
                num_graphs, batch_reduction="mean"):
    """``zᵀAz / vol(G)`` per graph for a score vector ``z ∈ [−1, 1]``
    (``vol``: the graph's edge weight, 1 where it is 0)."""
    edge_weight = check_and_filter_edge_weights(edge_weight)
    if scores.dim() == 2:
        scores = scores[:, 0]
    N = scores.shape[0]
    az = spmm(receivers, senders, edge_weight, scores[:, None], N)[:, 0]
    cut = segment_sum(scores * az, node_graph, num_graphs)
    vol = segment_sum(edge_weight, node_graph[senders.long()], num_graphs)
    vol = torch.where(vol == 0, 1.0, vol)
    return _batch_reduce(cut / vol, batch_reduction)
