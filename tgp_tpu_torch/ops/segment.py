"""Segment (scatter-reduce) primitives (port of ``tgp_tpu/ops/segment.py``).

Same contracts as the JAX functions: a fixed ``num_segments``, optional
element masks, ids outside ``[0, num_segments)`` dropped, and the same
fills for empty segments.  None of them syncs with the device.

Float sums add in a fixed order, so a sum gives the same bits every run:
:func:`segment_sum` on f32 and bf16 data sums each segment by K4 after a
stable sort of its ids, and :func:`gather_rows` (a row gather) sums its
gradient the same way.  Integer sums add by ``index_add_``: integers add
exactly in any order.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "segment_sum",
    "gather_rows",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_count",
    "segment_normalize",
    "segment_topk_rank",
    "node_cells",
    "dense_rows",
    "node_rows",
]

Tensor = torch.Tensor

#: the dtypes K4 sums (in a fixed order); other dtypes keep ``index_add_``
_ORDERED_DTYPES = (torch.float32, torch.bfloat16)


def _bcast(mask: Tensor, like: Tensor) -> Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _in_range(ids: Tensor, num_segments: int):
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, 0), ok


def _sorted_layout(ids: Tensor, num_segments: int, ids_sorted: bool):
    """``(perm, row_ptr)`` of ids clipped to ``[0, num_segments)``: the
    int32 order of a stable sort (the identity when ``ids_sorted``) and
    the ``[num_segments + 1]`` int32 offsets of each segment's run, from
    ``searchsorted`` on the device."""
    cids = ids.to(torch.int64).clamp(0, num_segments - 1).to(torch.int32)
    if ids_sorted:
        rids = cids
        perm = torch.arange(cids.shape[0], dtype=torch.int32,
                            device=cids.device)
    else:
        rids, perm = torch.sort(cids, stable=True)
        perm = perm.to(torch.int32)
    row_ptr = torch.searchsorted(
        rids, torch.arange(num_segments + 1, dtype=torch.int32,
                           device=ids.device), out_int32=True)
    return perm, row_ptr


def _ordered_sum(rows: Tensor, ids: Tensor, keep: Tensor, num_segments: int,
                 perm: Tensor, row_ptr: Tensor) -> Tensor:
    """K4's ``gather_segment_sum`` of ``rows [n, ...]`` through ``perm``
    and ``row_ptr``, rows whose ``keep`` is False skipped."""
    from tgp_tpu_torch.ops.kernels.segment_spmm import gather_segment_sum

    flat = rows.reshape(rows.shape[0], -1).contiguous()
    cids = ids.to(torch.int64).clamp(0, num_segments - 1).to(torch.int32)
    out = gather_segment_sum(flat, perm, keep, cids, row_ptr, num_segments)
    return out.reshape((num_segments,) + rows.shape[1:])


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int,
                mask=None, *, ids_sorted: bool = False) -> Tensor:
    """Masked segment sum: ``out[s] = Σ_{i: seg[i]==s, mask[i]} data[i]``.

    f32 and bf16 data add each segment's elements in a fixed order (the
    same bits every run): a stable sort of the (clipped) ids gives the
    segments' runs, per-segment offsets come from ``searchsorted`` on
    the device (no host sync), and K4's ``gather_segment_sum`` sums each
    run reading the rows through the sort order, skipping masked and
    out-of-range ones (a CUDA kernel on the card, its plain version on
    the CPU).  ``ids_sorted`` says the ids already ascend, so no sort is
    made.  Its gradient is a gather.  Other dtypes (integers add exactly
    in any order) and ``num_segments = 0`` add by ``index_add_``."""
    ids, ok = _in_range(segment_ids, num_segments)
    keep = ok if mask is None else ok & mask
    if (data.dtype in _ORDERED_DTYPES and num_segments > 0
            and data.shape[0] > 0):
        perm, row_ptr = _sorted_layout(segment_ids, num_segments, ids_sorted)
        return _ordered_sum(data, segment_ids, keep, num_segments, perm,
                            row_ptr)
    data = torch.where(_bcast(keep, data), data, 0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)


class _GatherRows(torch.autograd.Function):
    """``x.index_select(0, idx)`` whose gradient sums the cotangent rows
    of each index in a fixed order (K4 over a stable sort of ``idx``),
    where ``index_select``'s is one ``index_add_`` (float atomics on the
    card)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        n = ctx.num_rows
        perm, row_ptr = _sorted_layout(idx, n, False)
        keep = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
        return _ordered_sum(g, idx, keep, n, perm, row_ptr), None


def gather_rows(x: Tensor, idx: Tensor, num_rows: int) -> Tensor:
    """Rows ``x[idx]`` (``x [num_rows, ...]``, ids in ``[0, num_rows)``)
    by ``index_select``; its gradient adds the rows of each id in a fixed
    order (the same bits every run).  A tensor that takes no gradient (or
    an integer one) is gathered as it is."""
    if x.shape[0] != num_rows:
        raise ValueError(f"gather_rows: x has {x.shape[0]} rows, "
                         f"num_rows is {num_rows}")
    idx = idx.long()
    if not (torch.is_grad_enabled() and x.requires_grad) \
            or x.dtype not in _ORDERED_DTYPES or num_rows == 0:
        return x.index_select(0, idx)
    return _GatherRows.apply(x, idx)


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
                    mask=None, *, ids_sorted: bool = False) -> Tensor:
    """Per-segment softmax; masked entries get 0 and do not enter the
    normalizer (summed by :func:`segment_sum`, ``ids_sorted`` passed
    on)."""
    m = segment_max(scores, segment_ids, num_segments, mask=mask)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ids = segment_ids.long().clamp(0, num_segments - 1)
    e = torch.exp(scores - m[ids])
    if mask is not None:
        e = torch.where(_bcast(mask, e), e, 0.0)
    denom = segment_sum(e, segment_ids, num_segments, ids_sorted=ids_sorted)
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
    """Rows ``t [N, C]`` placed in ``[B, max_nodes, C]`` by node.  With
    ``node_mask`` each valid node writes its own cell and the masked ones
    a spare row past the end (padding nodes share a cell with a real
    one), so no float is added; without it, rows sharing a cell add.
    Its gradient is a row gather."""
    cells = num_graphs * max_nodes
    cell = node_cells(node_graph, node_pos, max_nodes)
    if node_mask is None:
        out = t.new_zeros(cells, t.shape[1]).index_add(0, cell, t)
    else:
        cell = torch.where(node_mask, cell, cells)
        out = t.new_zeros(cells + 1, t.shape[1]).index_put(
            (cell,), t)[:cells]
    return out.view(num_graphs, max_nodes, t.shape[1])


class _NodeRows(torch.autograd.Function):
    """Row ``cell[i]`` of ``flat [C + 1, F]`` for each node; each real
    node owns its cell and the masked ones read the spare row ``C``, so
    the gradient writes each node's row to its cell (no float sum)."""

    @staticmethod
    def forward(ctx, flat, cell):
        ctx.save_for_backward(cell)
        ctx.rows = flat.shape[0]
        return flat.index_select(0, cell)

    @staticmethod
    def backward(ctx, g):
        cell, = ctx.saved_tensors
        out = g.new_zeros(ctx.rows, g.shape[1]).index_put_((cell,), g)
        # the masked nodes' writes all land on the spare row
        out[-1] = 0
        return out, None


def node_rows(t: Tensor, node_graph: Tensor, node_pos: Tensor,
              node_mask: Tensor) -> Tensor:
    """``[N, C]`` rows of a ``[B, max_nodes, C]`` tensor at each node's
    cell (the inverse of :func:`dense_rows`), zero on masked nodes.  Each
    valid node owns its cell, so the gradient is a plain indexed write,
    not a sum."""
    B, M, C = t.shape
    spare = B * M
    cell = torch.where(node_mask, node_cells(node_graph, node_pos, M), spare)
    flat = torch.cat([t.reshape(spare, C), t.new_zeros(1, C)])
    return _NodeRows.apply(flat, cell)
