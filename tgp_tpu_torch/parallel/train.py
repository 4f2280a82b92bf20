"""Data-parallel training over the ranks of a process group (port of
``tgp_tpu/parallel/train.py``): per-rank batches of the same static
shapes are stacked on a leading ``dp`` axis, each rank differentiates its
own, the gradients of the replicated parameters are averaged over the
ranks in rank order, and every rank applies the same ``torch.optim``
update (``optax``'s ``tx`` becomes the optimizer)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from tgp_tpu_torch.parallel._collectives import (backward_replicated,
                                                 group_rank, pmean,
                                                 psum_grads_)

__all__ = ["make_mesh", "stack_batches", "make_dp_train_step"]


def _world() -> int:
    """Ranks in the default process group (a process without one is a
    world of one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a process group: call "
            "torch.distributed.init_process_group (or run under "
            "tgp_tpu_torch.parallel.launch.spawn_world) first")


def make_mesh(n_devices: int | None = None, axis: str = "dp"):
    """A 1-D ``DeviceMesh`` over the first ``n_devices`` ranks (all by
    default) named ``axis``, on the cards under NCCL and the CPU under
    gloo.  Raises when the world is smaller than asked: a truncated mesh
    would run partitions made for ``n_devices`` ranks on fewer (wrong
    numbers, not slow ones)."""
    world = _world()
    n = n_devices or world
    if n > world:
        raise ValueError(
            f"make_mesh({n}) but only {world} rank(s) visible in the "
            f"process group; start a world of {n} ranks (spawn_world, "
            "torchrun)")
    _require_group("make_mesh")
    from torch.distributed.device_mesh import DeviceMesh

    if _device_type() == "cuda" and torch.cuda.device_count() < 1:
        raise ValueError("an NCCL world with no visible CUDA device")
    return DeviceMesh(_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def _stack(items: Sequence[Any]):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(b, f.name) for b in items])
            for f in dataclasses.fields(first)})
    if isinstance(first, Mapping):
        return {k: _stack([b[k] for b in items]) for k in first}
    if any(b != first for b in items[1:]):
        raise ValueError(f"batches disagree on static metadata: {first!r}")
    return first


def stack_batches(batches: Sequence[Any]):
    """Stack per-rank batches (a :class:`~tgp_tpu_torch.graph.GraphBatch`,
    a tensor, or a dict of them) on a new leading ``dp`` axis; their
    static metadata (ints, flags) must agree."""
    return _stack(list(batches))


def _entry(stacked: Any, i: int):
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    if dataclasses.is_dataclass(stacked) and not isinstance(stacked, type):
        return dataclasses.replace(stacked, **{
            f.name: _entry(getattr(stacked, f.name), i)
            for f in dataclasses.fields(stacked)})
    if isinstance(stacked, Mapping):
        return {k: _entry(v, i) for k, v in stacked.items()}
    return stacked


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       mesh, axis: str = "dp"):
    """A data-parallel train step on ``mesh``'s ``axis``.

    ``loss_fn(params, batch, y) -> scalar`` is the per-rank loss;
    ``params`` is what ``optimizer`` updates (a dict or sequence of
    tensors).  The step ``step(params, stacked_batch, stacked_y) -> loss``
    takes entry ``d`` of the stacked batch (:func:`stack_batches`) on rank
    ``d``, differentiates the ``pmean`` of the per-rank losses (each
    rank's gradient is then ``1/D`` of its own; they are summed over the
    ranks in rank order: the mean gradient), and applies
    ``optimizer.step()`` identically on every rank.  Returns the mean
    loss, detached.  A weight-decay optimizer (AdamW) reads the
    parameters as ``optax``'s ``tx.update(grads, state, params)`` does."""
    group = mesh.get_group(axis)

    def step(params, batch, y):
        d = group_rank(group)
        tensors = list(params.values() if isinstance(params, Mapping)
                       else params)
        optimizer.zero_grad(set_to_none=True)
        loss = pmean(loss_fn(params, _entry(batch, d), _entry(y, d)), group)
        backward_replicated(loss, group)
        psum_grads_(tensors, [group])
        optimizer.step()
        return loss.detach()

    return step
