"""The collectives of the sharded layer, as ``torch.autograd.Function``\\ s
over a ``torch.distributed`` process group (a ``DeviceMesh`` axis's
``mesh.get_group(axis)``): ``shard_map``'s ``all_gather(tiled=True)``,
``psum``, ``pmean`` and ``ppermute``.

**The gradient convention.**  JAX tracks which values are replicated over
an axis; torch does not, so one rule is kept everywhere: the true
cotangent of a replicated value is the *sum over the ranks* of its local
cotangents, and a sharded value's local cotangent is its whole cotangent.
So a replicated loss is seeded with ``1/D`` on each rank
(:func:`backward_replicated`), the backward of ``psum`` is a ``psum``, the
backward of the tiled ``all_gather`` is a reduce-scatter (sum), the
backward of ``pmean`` is a ``pmean``, and the gradients of replicated
parameters are summed over the ranks (:func:`psum_grads_`).

**Fixed order.**  Every float sum across ranks adds the ranks' values in
rank order (an ``all_gather`` of the addends, then a sum over the rank
axis, one rank at a time), so repeats at one world size give the same
bits; a reduce-scatter gathers each rank's rows with ``all_to_all`` and
adds them the same way.

Every collective appends ``(op, shape, dtype, bytes)`` to :data:`COMM_LOG`
(its forward and, as ``"<op>_backward"``, its backward): the gathered
tensor of an ``all_gather`` (``[D·rows, ...]``, a ``psum``'s ``[D, ...]``
addends), the tensor a ``ppermute`` sends and the one a reduce-scatter
splits; the port's counterpart of reading the collectives from JAX's
HLO.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

__all__ = ["COMM_LOG", "all_gather_rows", "psum", "pmean", "ppermute",
           "ordered_psum", "psum_grads_", "backward_replicated",
           "local_shard", "group_size", "group_rank"]

#: ``(op, shape, dtype, bytes)`` of every collective made
COMM_LOG: List[tuple] = []

# torch 2.13 renames all_gather_into_tensor (and warns on the old name)
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _log(op: str, t: torch.Tensor) -> None:
    COMM_LOG.append((op, tuple(t.shape), t.dtype,
                     t.numel() * t.element_size()))


def _gather_stack(t: torch.Tensor, group, op: str) -> torch.Tensor:
    """``[D, *t.shape]``: every rank's ``t`` in rank order (logged as the
    gathered tensor)."""
    one = t.contiguous().reshape((1,) + tuple(t.shape))
    out = torch.empty((group_size(group),) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    _all_gather_into(out, one, group=group)
    _log(op, out)
    return out


def _sum_ranks(stack: torch.Tensor) -> torch.Tensor:
    """``stack[0] + stack[1] + …`` in rank order."""
    acc = stack[0].clone()
    for i in range(1, stack.shape[0]):
        acc = acc + stack[i]
    return acc


def ordered_psum(t: torch.Tensor, group, op: str = "psum") -> torch.Tensor:
    """Σ over the ranks of ``t``, in rank order (no gradient)."""
    return _sum_ranks(_gather_stack(t, group, op))


def _reduce_scatter_rows(t: torch.Tensor, group, op: str) -> torch.Tensor:
    """Rank ``d``'s block of rows of ``Σ_ranks t`` (``t [D·rows, ...]``),
    added in rank order.  At D = 1 it is ``t`` itself: nothing is sent."""
    D = group_size(group)
    if D == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    _log(op, t)
    dist.all_to_all_single(out, t, group=group)
    return _sum_ranks(out.reshape((D, t.shape[0] // D) + tuple(t.shape[1:])))


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        stack = _gather_stack(x, group, "all_gather")
        return stack.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_rows(g, ctx.group, "all_gather_backward"), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)``: every rank's ``x``
    (``[rows, ...]``) stacked on the row axis in rank order
    (``[D·rows, ...]``).  Its gradient is a reduce-scatter (sum)."""
    return _AllGatherRows.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ordered_psum(x, group, "psum")

    @staticmethod
    def backward(ctx, g):
        return ordered_psum(g, ctx.group, "psum_backward"), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum``: Σ over the ranks in rank order; its gradient is a
    ``psum`` of the cotangent."""
    return _Psum.apply(x, group)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ordered_psum(x, group, "pmean") / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return (ordered_psum(g, ctx.group, "pmean_backward")
                / group_size(ctx.group)), None


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.pmean``; its gradient is a ``pmean`` of the cotangent."""
    return _Pmean.apply(x, group)


def _shift(x: torch.Tensor, group, shift: int, op: str) -> torch.Tensor:
    """Send ``x`` to rank ``(d + shift) mod D``, receive from ``(d − shift)
    mod D``.  At D = 1 the ring is the identity and nothing is sent (NCCL
    does not send to its own rank)."""
    D = group_size(group)
    if D == 1:
        return x
    d = group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _log(op, x)
    to = dist.get_global_rank(group, (d + shift) % D)
    frm = dist.get_global_rank(group, (d - shift) % D)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift, "ppermute")

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift, "ppermute_backward"), None, \
            None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` on the ring ``d → d + shift``; its gradient
    sends the cotangent back around the ring."""
    return _Ppermute.apply(x, group, shift)


def backward_replicated(loss: torch.Tensor, group_or_size) -> None:
    """Backpropagate a loss replicated over ``D`` ranks: seeded with
    ``1/D`` on each rank (the convention above)."""
    D = (group_or_size if isinstance(group_or_size, int)
         else group_size(group_or_size))
    torch.autograd.backward(loss, torch.full_like(loss, 1.0 / D))


def psum_grads_(params: Iterable[torch.Tensor],
                groups: Iterable) -> None:
    """Sum each parameter's ``.grad`` over the ranks of every group in
    ``groups``, in turn and in rank order, in place (the gradient of a
    replicated parameter; a missing ``.grad`` counts as zeros)."""
    params = list(params)
    for group in groups:
        for p in params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = ordered_psum(g, group, "grad_psum")


def local_shard(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t`` split into ``D`` equal parts along
    ``dim`` (a ``P(axis)`` sharding)."""
    D = group_size(group)
    r = group_rank(group)
    if t.shape[dim] % D:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"into {D} equal shards")
    n = t.shape[dim] // D
    return t.narrow(dim, r * n, n)
