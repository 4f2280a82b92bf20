"""Segment (scatter-reduce) primitives (port of ``tgp_tpu/ops/segment.py``).

Same contracts as the JAX functions: a fixed ``num_segments``, optional
element masks, ids outside ``[0, num_segments)`` dropped, and the same
fills for empty segments.  None of them syncs with the device.
"""

from __future__ import annotations

import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_count",
    "segment_normalize",
    "segment_topk_rank",
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
                    mask=None) -> Tensor:
    """Per-segment softmax; masked entries get 0 and do not enter the
    normalizer."""
    m = segment_max(scores, segment_ids, num_segments, mask=mask)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ids = segment_ids.long().clamp(0, num_segments - 1)
    e = torch.exp(scores - m[ids])
    if mask is not None:
        e = torch.where(_bcast(mask, e), e, 0.0)
    denom = torch.clamp(segment_sum(e, segment_ids, num_segments), min=1e-16)
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
