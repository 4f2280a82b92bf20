"""Sparse connectivity ops under static shapes (port of
``tgp_tpu/ops/sparse.py``): coalesce, degree, self-loops, SpMM, adjacency
post-processing, and the regime maps that route SpMM to the CUDA kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.ops.segment import (
    segment_max,
    segment_normalize,
    gather_rows,
    segment_sum,
)

__all__ = [
    "check_and_filter_edge_weights",
    "coalesce",
    "weighted_degree",
    "remove_self_loops",
    "add_remaining_self_loops",
    "use_kernel_spmm",
    "spmm_route",
    "use_dense_pipeline",
    "use_dense_vote",
    "DENSE_VOTE_BUDGET",
    "spmm",
    "spmm_batch",
    "normalize_adj_sym",
    "postprocess_adj_sparse",
    "postprocess_adj_dense",
    "rank3_trace",
    "rank3_diag",
    "sddmm",
]

Tensor = torch.Tensor


def check_and_filter_edge_weights(edge_weight):
    """Flatten ``[E, 1]`` weights to ``[E]``; other multi-dim shapes raise."""
    if edge_weight is not None and edge_weight.dim() > 1:
        if edge_weight.dim() == 2 and edge_weight.shape[-1] == 1:
            edge_weight = edge_weight.reshape(-1)
        else:
            raise ValueError(
                "Edge weights must be of shape [E] or [E, 1], but got "
                f"{tuple(edge_weight.shape)}.")
    return edge_weight


def coalesce(senders, receivers, edge_weight, edge_mask, num_nodes: int,
             reduce: str = "sum"):
    """Merge duplicate ``(sender, receiver)`` edges with a static edge
    budget: sort by ``(receiver, sender)`` (invalid edges last), reduce
    each run of equal keys into its head, mask the rest.  Each run's sum
    (and ``mean``'s count) adds in run order by
    :func:`~tgp_tpu_torch.ops.segment.segment_sum` (K4 on the
    card), so a merge gives the same bits every run.

    The output is JAX's merged edge set in another order: the masked
    slots first (``0 → 0``, weight 0), then the heads ascending by
    receiver, as ``from_graphs(sort_edges=True)`` lays edges out (JAX
    leaves each head at its run's first slot in sender-major order)."""
    E = senders.shape[0]
    s_k = torch.where(edge_mask, senders, num_nodes).long()
    r_k = torch.where(edge_mask, receivers, num_nodes).long()
    # lexsort: stable sort by the sender, then the receiver
    order = torch.sort(s_k, stable=True).indices
    order = order[torch.sort(r_k[order], stable=True).indices]
    ss, rs = s_k[order], r_k[order]
    sw = torch.where(edge_mask, edge_weight, 0.0)[order]
    is_head = torch.ones(E, dtype=torch.bool, device=senders.device)
    is_head[1:] = (ss[1:] != ss[:-1]) | (rs[1:] != rs[:-1])
    run_id = torch.cumsum(is_head.to(torch.int64), 0) - 1
    if reduce in ("sum", "mean"):
        run_val = segment_sum(sw, run_id, E, ids_sorted=True)
        if reduce == "mean":
            run_val = run_val / torch.clamp(segment_sum(
                torch.ones_like(sw), run_id, E, ids_sorted=True), min=1.0)
    elif reduce == "max":
        run_val = segment_max(sw, run_id, E)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    valid = is_head & (ss < num_nodes)
    w_out = torch.where(valid, run_val[run_id], 0.0)
    s_out = torch.where(valid, senders[order], 0)
    r_out = torch.where(valid, receivers[order], 0)
    # masked slots first, then the heads in key order: a permutation from
    # two running counts (no sort, no host sync)
    n_masked = E - valid.sum()
    dest = torch.where(valid, n_masked + torch.cumsum(valid, 0) - 1,
                       torch.cumsum(~valid, 0) - 1)
    return tuple(torch.empty_like(t).index_put_((dest,), t)
                 for t in (s_out, r_out, w_out, valid))


def weighted_degree(index, weight, num_nodes: int, mask=None):
    """Per-node (weighted) degree."""
    if weight is None:
        weight = torch.ones(index.shape[0], dtype=torch.float32,
                            device=index.device)
    return segment_sum(weight, index, num_nodes, mask=mask)


def remove_self_loops(senders, receivers, edge_weight, edge_mask):
    """Mask out self-loop edges (static shape; no compaction)."""
    keep = edge_mask & (senders != receivers)
    return senders, receivers, torch.where(keep, edge_weight, 0.0), keep


def add_remaining_self_loops(senders, receivers, edge_weight, edge_mask,
                             node_mask, fill_value: float = 1.0):
    """Append one self-loop slot per node (budget ``E + N``); existing
    self-loops keep their weight, the appended slot of a node that has one
    is masked out."""
    N = node_mask.shape[0]
    has_loop = segment_sum((edge_mask & (senders == receivers)).to(torch.int32),
                           senders, N) > 0
    loop_idx = torch.arange(N, dtype=senders.dtype, device=senders.device)
    new_mask = node_mask & ~has_loop
    s = torch.cat([senders, loop_idx])
    r = torch.cat([receivers, loop_idx])
    w = torch.cat([edge_weight,
                   torch.where(new_mask, fill_value, 0.0).to(edge_weight.dtype)])
    m = torch.cat([edge_mask, new_mask])
    return s, r, w, m


#: regime boundary carried over from the JAX package (measured on a TPU
#: there); untuned on the H100 — kept so both packages take the same
#: branches on the same batch
PALLAS_MIN_EDGES = 1 << 18


def use_kernel_spmm(num_edges: int, edges_sorted: bool,
                    device: torch.device) -> bool:
    """Route the SpMM through the CUDA sorted-CSR kernel iff the edges are
    receiver-sorted, at least :data:`PALLAS_MIN_EDGES`, and on CUDA."""
    return (edges_sorted and num_edges >= PALLAS_MIN_EDGES
            and torch.device(device).type == "cuda")


def spmm_route(batch, use_kernel: Optional[bool] = None) -> str:
    """A layer's SpMM route over ``batch``, in the kernel regime (its
    ``use_kernel``; None applies :func:`use_kernel_spmm`) with
    receiver-sorted edges: ``"csr"`` (K1) with the collator's CSR
    metadata, ``"sorted"`` without; else ``"generic"``."""
    if use_kernel is None:
        use_kernel = use_kernel_spmm(batch.num_edges, batch.edges_sorted,
                                     batch.device)
    if not (use_kernel and batch.edges_sorted):
        return "generic"
    return "sorted" if batch.row_ptr is None else "csr"


def _spmm_csr_batch(batch, x, w, w_t):
    """K1 over ``batch``'s CSR layout, ``w`` and ``w_t`` (None: no
    gradient for ``x``) the weights in its two orders, cast to f32."""
    from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

    return spmm_csr(x.contiguous(), w.to(torch.float32),
                    None if w_t is None else w_t.to(torch.float32),
                    batch.senders, batch.receivers, batch.row_ptr,
                    batch.receivers_t, batch.senders_t, batch.row_ptr_t,
                    batch.num_nodes)


#: model-level crossover carried over from the JAX package; untuned on
#: the H100
DENSE_PIPELINE_MAX_NODES = 2048
DENSE_PIPELINE_MAX_ADJ_BYTES = 2 << 30


def use_dense_pipeline(num_graphs: int, max_nodes: int,
                       itemsize: int = 4) -> bool:
    """Route a batch of small graphs to the dense pipeline iff the
    per-graph width is under the crossover and the ``[B, Nmax, Nmax]``
    adjacency fits the byte budget (static batch metadata only)."""
    return (max_nodes <= DENSE_PIPELINE_MAX_NODES
            and num_graphs * max_nodes * max_nodes * itemsize
            <= DENSE_PIPELINE_MAX_ADJ_BYTES)


#: the dense combinatorial engines' budget, carried over from the JAX
#: package: the per-graph ``[B, Nmax, Nmax]`` loop runs while it holds at
#: most 16M elements (64 MiB of int32)
DENSE_VOTE_BUDGET = 2 ** 24


def use_dense_vote(num_graphs: int, max_nodes: int) -> bool:
    """Take the dense engines (matching, MIS) iff ``B·Nmax²`` fits
    :data:`DENSE_VOTE_BUDGET` (static batch metadata only)."""
    return num_graphs * max_nodes ** 2 <= DENSE_VOTE_BUDGET


def spmm(senders, receivers, edge_weight, x, num_nodes: int, *,
         indices_are_sorted: bool = False, method: str = "auto"):
    """``(A X)[r] = Σ_{e: recv[e]=r} w_e · x[send_e]``, every sum in a
    fixed order.

    ``method``: ``"auto"`` applies :func:`use_kernel_spmm`; ``"torch"``
    (gather + :func:`~tgp_tpu_torch.ops.segment.segment_sum`, which sorts
    the receivers unless ``indices_are_sorted``) and ``"kernel"`` (the
    sorted segment-sum kernel; receiver-sorted edges required) force a
    path.  The gather is :func:`~tgp_tpu_torch.ops.segment.gather_rows`,
    whose gradient sorts the senders."""
    if method == "auto":
        method = ("kernel" if use_kernel_spmm(
            senders.shape[0], indices_are_sorted, x.device) else "torch")
    edge_weight = check_and_filter_edge_weights(edge_weight)
    msgs = gather_rows(x, senders, x.shape[0]) * edge_weight[:, None]
    if method == "kernel":
        if not indices_are_sorted:
            raise ValueError(
                "spmm(method='kernel') requires indices_are_sorted=True "
                "(receiver-ascending edges)")
        from tgp_tpu_torch.ops.kernels.segment_spmm import segment_sum_sorted

        return segment_sum_sorted(msgs.contiguous(), receivers, num_nodes)
    if method != "torch":
        raise ValueError(f"unknown spmm method {method!r}")
    return segment_sum(msgs, receivers, num_nodes,
                       ids_sorted=indices_are_sorted)


def spmm_batch(batch, x=None, *, abs_weights: bool = False):
    """``A X`` over a :class:`~tgp_tpu_torch.graph.GraphBatch` on the
    fastest path: the CSR kernel on :func:`spmm_route`'s ``"csr"``, else
    gather + segment-sum.  Masked pooled graphs (``node_mask_shrunk``)
    cover the induced subgraph; ``abs_weights`` aggregates with ``|w|``."""
    if x is None:
        x = batch.x
    w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
    w_t = batch.edge_weight_t
    if abs_weights:
        w = w.abs()
        w_t = None if w_t is None else w_t.abs()
    nm = batch.node_mask
    if spmm_route(batch) == "csr":
        x_in = x * nm[:, None].to(x.dtype) if batch.node_mask_shrunk else x
        return _spmm_csr_batch(batch, x_in, w, w_t)
    if batch.node_mask_shrunk:
        s, r = batch.senders.long(), batch.receivers.long()
        w = w * (nm[s] & nm[r])
    return spmm(batch.senders, batch.receivers, w, x, batch.num_nodes,
                indices_are_sorted=batch.edges_sorted)


def normalize_adj_sym(senders, receivers, edge_weight, edge_mask,
                      num_nodes: int, eps: float = 1e-12):
    """Symmetric degree normalization ``D^{-1/2} A D^{-1/2}`` on masked COO
    (degrees from ``|w|``)."""
    deg = weighted_degree(receivers, edge_weight.abs(), num_nodes,
                          mask=edge_mask)
    dinv = torch.where(deg > eps, torch.rsqrt(torch.clamp(deg, min=eps)), 0.0)
    w = edge_weight * dinv[senders.long()] * dinv[receivers.long()]
    return torch.where(edge_mask, w, 0.0)


def postprocess_adj_sparse(senders, receivers, edge_weight, edge_mask,
                           node_graph, num_nodes: int, num_graphs: int, *,
                           remove_self_loops_flag: bool = True,
                           degree_norm: bool = False,
                           edge_weight_norm: bool = False,
                           prune_eps=None):
    """Pooled-adjacency post-processing, sparse world: optional self-loop
    removal, ε-pruning, symmetric degree norm (sender-side plain degree,
    clamped at 1e-8) and per-graph max-abs weight normalization."""
    w, m = edge_weight, edge_mask
    if remove_self_loops_flag:
        senders, receivers, w, m = remove_self_loops(senders, receivers, w, m)
    if prune_eps is not None:
        keep = m & (w.abs() > prune_eps)
        w = torch.where(keep, w, 0.0)
        m = keep
    if degree_norm:
        deg = weighted_degree(senders, w, num_nodes, mask=m)
        dinv = torch.rsqrt(torch.clamp(deg, min=1e-8))
        w = w * dinv[senders.long()] * dinv[receivers.long()]
        w = torch.where(m, w, 0.0)
    if edge_weight_norm:
        edge_graph = node_graph[senders.long()]
        w = segment_normalize(w, edge_graph, num_graphs, mask=m,
                              ord="max_abs")
        w = torch.where(m, w, 0.0)
    return senders, receivers, w, m


def postprocess_adj_dense(adj, mask=None, *, remove_self_loops_flag=True,
                          degree_norm=False, edge_weight_norm=False,
                          adj_transpose=False, eps: float = 1e-8):
    """Pooled-adjacency post-processing, dense world ``[B, K, K]``."""
    B, K, _ = adj.shape
    if remove_self_loops_flag:
        adj = adj * (1.0 - torch.eye(K, dtype=adj.dtype, device=adj.device))
    if degree_norm:
        a = adj.transpose(-1, -2) if adj_transpose else adj
        dinv = torch.rsqrt(torch.clamp(a.sum(-1), min=eps))
        a = dinv[..., :, None] * a * dinv[..., None, :]
        adj = a.transpose(-1, -2) if adj_transpose else a
    if edge_weight_norm:
        mx = adj.abs().reshape(B, -1).amax(-1)
        mx = torch.where(mx > eps, mx, 1.0)
        adj = adj / mx[:, None, None]
    if mask is not None:
        m = mask.to(adj.dtype)
        adj = adj * m[:, :, None] * m[:, None, :]
    return adj


def rank3_trace(x: Tensor) -> Tensor:
    """Batched trace of ``[B, N, N]`` → ``[B]``."""
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def rank3_diag(x: Tensor) -> Tensor:
    """``[B, N]`` → batched diagonal matrices ``[B, N, N]``."""
    return torch.diag_embed(x)


def sddmm(senders, receivers, a: Tensor, b: Tensor) -> Tensor:
    """Sampled dense-dense product: per edge ``⟨a[s_e], b[r_e]⟩`` (the
    edge-wise ``⟨S_i, S_j⟩`` of the sparse loss twins; two
    :func:`~tgp_tpu_torch.ops.segment.gather_rows`, not the banded K6
    kernel)."""
    return (gather_rows(a, senders, a.shape[0])
            * gather_rows(b, receivers, b.shape[0])).sum(-1)
