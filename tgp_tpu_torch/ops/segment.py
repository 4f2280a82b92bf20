"""Segment (scatter-reduce) primitives (port of ``tgp_tpu/ops/segment.py``).

Same contracts as the JAX functions: a fixed ``num_segments``, optional
element masks, ids outside ``[0, num_segments)`` dropped, and the same
fills for empty segments.  None of them syncs with the device.

:func:`segment_sum` adds by ``index_add_`` (float atomics on the card, so
the bits of a sum may differ run to run); :func:`segment_sum_ordered` is
its function with every segment summed in a fixed order, by K4.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "segment_sum",
    "segment_sum_ordered",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_count",
    "segment_normalize",
    "segment_topk_rank",
    "node_cells",
    "dense_rows",
]

Tensor = torch.Tensor


def _bcast(mask: Tensor, like: Tensor) -> Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _in_range(ids: Tensor, num_segments: int):
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, 0), ok


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int,
                mask=None) -> Tensor:
    """Masked scatter-add: ``out[s] = Σ_{i: seg[i]==s, mask[i]} data[i]``."""
    ids, ok = _in_range(segment_ids, num_segments)
    keep = ok if mask is None else ok & mask
    data = torch.where(_bcast(keep, data), data, 0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)


def segment_sum_ordered(data: Tensor, segment_ids: Tensor,
                        num_segments: int, mask=None, *,
                        ids_sorted: bool = False) -> Tensor:
    """:func:`segment_sum` with each segment's elements added in a fixed
    order (the same bits every run): a stable sort of the (clipped) ids
    gives the segments' runs, per-segment offsets come from
    ``searchsorted`` on the device (no host sync), and K4's
    ``gather_segment_sum`` sums each run reading the rows through the
    sort order, skipping masked and out-of-range ones (a CUDA kernel on
    the card, its plain version on the CPU).  ``ids_sorted`` says the ids
    already ascend, so no sort is made.  Its gradient is a gather.  K4
    takes f32 and bf16 data; other dtypes (integers add exactly in any
    order) and ``num_segments = 0`` keep :func:`segment_sum`."""
    if (data.dtype not in (torch.float32, torch.bfloat16)
            or num_segments == 0):
        return segment_sum(data, segment_ids, num_segments, mask=mask)
    from tgp_tpu_torch.ops.kernels.segment_spmm import gather_segment_sum

    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask
    cids = ids.clamp(0, num_segments - 1).to(torch.int32)
    if ids_sorted:
        rids = cids
        perm = torch.arange(cids.shape[0], dtype=torch.int32,
                            device=cids.device)
    else:
        rids, perm = torch.sort(cids, stable=True)
        perm = perm.to(torch.int32)
    row_ptr = torch.searchsorted(
        rids, torch.arange(num_segments + 1, dtype=torch.int32,
                           device=data.device), out_int32=True)
    out = gather_segment_sum(data.reshape(data.shape[0], -1).contiguous(),
                             perm, keep, cids, row_ptr, num_segments)
    return out.reshape((num_segments,) + data.shape[1:])


def segment_count(segment_ids: Tensor, num_segments: int,
                  mask=None) -> Tensor:
    """``[num_segments]`` int32 element count per segment."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.int32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask=mask)


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int,
                 mask=None, eps: float = 1e-12) -> Tensor:
    s = segment_sum(data, segment_ids, num_segments, mask=mask)
    c = segment_count(segment_ids, num_segments, mask=mask).to(s.dtype)
    c = torch.clamp(c, min=eps)
    return s / _bcast(c, s)


def _segment_extreme(data, segment_ids, num_segments, mask, reduce):
    is_float = data.dtype.is_floating_point
    if reduce == "amax":
        fill = -torch.inf if is_float else torch.iinfo(data.dtype).min
    else:
        fill = torch.inf if is_float else torch.iinfo(data.dtype).max
    ids, ok = _in_range(segment_ids, num_segments)
    keep = ok if mask is None else ok & mask
    data = torch.where(_bcast(keep, data), data,
                       torch.full((), fill, dtype=data.dtype,
                                  device=data.device))
    out = torch.full((num_segments,) + data.shape[1:], fill,
                     dtype=data.dtype, device=data.device)
    index = _bcast(ids, data).expand_as(data)
    return out.scatter_reduce_(0, index, data, reduce=reduce,
                               include_self=True)


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int,
                mask=None) -> Tensor:
    """Masked segment max; empty float segments are ``-inf``, empty int
    segments dtype-min."""
    return _segment_extreme(data, segment_ids, num_segments, mask, "amax")


def segment_min(data: Tensor, segment_ids: Tensor, num_segments: int,
                mask=None) -> Tensor:
    """Masked segment min; empty float segments are ``+inf``, empty int
    segments dtype-max."""
    return _segment_extreme(data, segment_ids, num_segments, mask, "amin")


def segment_softmax(scores: Tensor, segment_ids: Tensor, num_segments: int,
                    mask=None, *, ordered: bool = False,
                    ids_sorted: bool = False) -> Tensor:
    """Per-segment softmax; masked entries get 0 and do not enter the
    normalizer.  ``ordered`` sums the normalizer in a fixed order
    (:func:`segment_sum_ordered`, ``ids_sorted`` passed on)."""
    m = segment_max(scores, segment_ids, num_segments, mask=mask)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ids = segment_ids.long().clamp(0, num_segments - 1)
    e = torch.exp(scores - m[ids])
    if mask is not None:
        e = torch.where(_bcast(mask, e), e, 0.0)
    denom = (segment_sum_ordered(e, segment_ids, num_segments,
                                 ids_sorted=ids_sorted) if ordered
             else segment_sum(e, segment_ids, num_segments))
    denom = torch.clamp(denom, min=1e-16)
    return e / denom[ids]


def segment_normalize(data: Tensor, segment_ids: Tensor, num_segments: int,
                      mask=None, ord: str = "max_abs",
                      eps: float = 1e-12) -> Tensor:
    """Per-segment normalization by the max |value| (``'max_abs'``) or the
    sum (``'sum'``); masked entries pass through unchanged."""
    if ord == "max_abs":
        denom = segment_max(data.abs(), segment_ids, num_segments, mask=mask)
    elif ord == "sum":
        denom = segment_sum(data, segment_ids, num_segments, mask=mask)
    else:
        raise ValueError(f"unknown ord {ord!r}")
    denom = torch.where(denom.abs() > eps, denom, 1.0)
    out = data / denom[segment_ids.long().clamp(0, num_segments - 1)]
    if mask is not None:
        out = torch.where(_bcast(mask, out), out, data)
    return out


def segment_topk_rank(scores: Tensor, segment_ids: Tensor, num_segments: int,
                      mask=None) -> Tensor:
    """Rank of each element within its segment by descending score:
    ``[N]`` int32, 0 for the largest valid score; masked elements rank
    after all valid ones; ties break by index.  Three stable sorts from
    the least significant key up (score desc, then validity, then
    segment) give the same order as the JAX lexsort."""
    n = scores.shape[0]
    dev = scores.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    order = torch.sort(-scores, stable=True).indices
    order = order[torch.sort((~mask[order]).to(torch.int8),
                             stable=True).indices]
    order = order[torch.sort(segment_ids[order], stable=True).indices]
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    pos[order] = torch.arange(n, device=dev)
    total = segment_count(segment_ids, num_segments).to(torch.int64)
    start = torch.cumsum(total, 0) - total
    seg = segment_ids.long().clamp(0, num_segments - 1)
    return (pos - start[seg]).to(torch.int32)


def node_cells(node_graph: Tensor, node_pos: Tensor, max_nodes: int
               ) -> Tensor:
    """``[N]`` int64 row ``graph · max_nodes + position`` of each node."""
    return node_graph.long() * max_nodes + node_pos.long()


def dense_rows(t: Tensor, node_graph: Tensor, node_pos: Tensor,
               num_graphs: int, max_nodes: int,
               node_mask: Optional[Tensor] = None) -> Tensor:
    """Rows ``t [N, C]`` scattered to ``[B, max_nodes, C]`` by node
    (masked rows add zeros: padding nodes share a cell with a real one).
    Its gradient is a row gather."""
    if node_mask is not None:
        t = torch.where(node_mask[:, None], t, 0.0)
    out = t.new_zeros(num_graphs * max_nodes, t.shape[1])
    out = out.index_add(0, node_cells(node_graph, node_pos, max_nodes), t)
    return out.view(num_graphs, max_nodes, t.shape[1])
