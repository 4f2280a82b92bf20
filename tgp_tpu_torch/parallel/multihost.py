"""Hybrid (DCN × ICI) mesh: data parallelism over groups of ranks and the
sharded pooled model within each group (port of
``tgp_tpu/parallel/multihost.py``).

* inner axis (``"ici"``): the edge-partitioned pooled forward of
  :mod:`~tgp_tpu_torch.parallel.pooled_model`, whose ``all_gather`` and
  ``psum`` run over the group's ranks;
* outer axis (``"dcn"``): each group trains on its own graph; the loss
  is the ``pmean`` over the groups and the parameters' gradients are
  summed over the whole mesh, in rank order.

Across hosts, :func:`initialize_multihost` joins the world from the
``torchrun`` environment (or an explicit address) before
:func:`make_hybrid_mesh`; on one host the same code runs on a reshaped
rank grid.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tgp_tpu_torch.parallel._collectives import (backward_replicated,
                                                 group_size, pmean,
                                                 psum_grads_)
from tgp_tpu_torch.parallel.pooled_model import _forward_local, level_ks
from tgp_tpu_torch.parallel.spmm import CsrLayout, _LayoutCache

__all__ = ["initialize_multihost", "make_hybrid_mesh",
           "make_hybrid_pooled_train_step", "stack_group_graphs",
           "device_put_hybrid"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> bool:
    """Join a multi-process world with ``init_process_group``: from an
    explicit ``coordinator_address`` (``host:port``, with
    ``num_processes`` and ``process_id``) or else from the ``torchrun``
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  Returns True when the world has more than one
    process, False when nothing is configured (so library code can call
    it unconditionally).  An explicit address that fails raises; NCCL
    where a card is visible, gloo elsewhere, unless ``backend`` says."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and not all(k in os.environ
                                               for k in _ENV):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        if coordinator_address is None:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
        else:
            if num_processes is None or process_id is None:
                raise ValueError("an explicit coordinator_address needs "
                                 "num_processes and process_id")
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, timeout=timeout)
    except Exception:
        if coordinator_address is not None:
            raise  # explicit configuration must fail loudly
        return False
    return dist.get_world_size() > 1


def make_hybrid_mesh(n_groups: int, per_group: int,
                     axes: Sequence[str] = ("dcn", "ici")):
    """``[n_groups, per_group]`` ``DeviceMesh`` over the first
    ``n_groups·per_group`` ranks, the inner axis on consecutive ranks (the
    ranks of one host under ``torchrun``)."""
    from tgp_tpu_torch.parallel.train import (_device_type, _require_group,
                                              _world)

    have = _world()
    if have < n_groups * per_group:
        raise ValueError(f"need {n_groups * per_group} devices, have {have}")
    _require_group("make_hybrid_mesh")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(),
                      torch.arange(n_groups * per_group).reshape(
                          n_groups, per_group), mesh_dim_names=tuple(axes))


def stack_group_graphs(prepped: Sequence[tuple]):
    """Stack per-group ``prepare_sharded_graph`` outputs ``(S, R, W,
    n_pad, rows_per)`` on a leading group axis, padding the edge budgets
    (with ``s = r = 0, w = 0``) to a common maximum.  All groups must
    share ``n_pad``."""
    n_pads = {p[3] for p in prepped}
    rows = {p[4] for p in prepped}
    if len(n_pads) != 1 or len(rows) != 1:
        raise ValueError(f"groups disagree on padding: {n_pads}, {rows}")
    e_max = max(p[0].shape[1] for p in prepped)

    def pad_e(a):
        return F.pad(a, (0, e_max - a.shape[1]))

    S = torch.stack([pad_e(p[0]) for p in prepped])
    R = torch.stack([pad_e(p[1]) for p in prepped])
    W = torch.stack([pad_e(p[2]) for p in prepped])
    return S, R, W, next(iter(n_pads)), next(iter(rows))


def make_hybrid_pooled_train_step(mesh, optimizer: torch.optim.Optimizer,
                                  *, rows_per: int, n_pad: int,
                                  num_valid: int, ratio: float = 0.5,
                                  num_levels: int = 1,
                                  dcn_axis: str = "dcn",
                                  ici_axis: str = "ici"):
    """A hybrid train step: ``(step, ks)``.  ``step(params, x_local, S_d,
    R_d, W_d, y_g) -> loss`` takes this rank's slices
    (:func:`device_put_hybrid`): rows ``x_local [rows_per, F]`` and the
    partition ``S/R/W [E_local]`` of its group's graph and the group's
    label ``y_g``.  The loss is the cross-entropy averaged over the groups
    (``pmean`` over ``dcn``); its gradients, summed over every rank of the
    mesh in rank order, update ``params`` (what ``optimizer`` holds) by
    ``optimizer.step()``.  Returns the mean loss, detached."""
    ici = mesh.get_group(ici_axis)
    dcn = mesh.get_group(dcn_axis)
    n_ici = group_size(ici)
    ks = level_ks(num_valid, ratio, num_levels, n_ici)
    cache = _LayoutCache(lambda s, r: CsrLayout(s, r, rows_per, n_pad))

    def step(params, x_local, S_d, R_d, W_d, y_g):
        optimizer.zero_grad(set_to_none=True)
        logits, _ = _forward_local(
            params, x_local, S_d, R_d, W_d, rows_per=rows_per,
            num_valid=num_valid, ks=ks, group=ici, layout=cache(S_d, R_d))
        ce = F.cross_entropy(logits[None], y_g.reshape(1).long())
        loss = pmean(ce, dcn)  # replicated over the whole mesh
        backward_replicated(loss, n_ici * group_size(dcn))
        psum_grads_(params.values(), [ici, dcn])
        optimizer.step()
        return loss.detach()

    return step, ks


def device_put_hybrid(mesh, X, S, R, W, y, dcn_axis: str = "dcn",
                      ici_axis: str = "ici"):
    """This rank's slices of the stacked group arrays (``X [G, n_pad, F]``,
    ``S/R/W [G, D_ici, E_local]``, ``y [G]``), on the mesh's device:
    ``(x_local, S_d, R_d, W_d, y_g)``."""
    g = mesh.get_local_rank(dcn_axis)
    i = mesh.get_local_rank(ici_axis)
    n_ici = mesh.size(mesh.mesh_dim_names.index(ici_axis))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    rows = X.shape[1] // n_ici
    return tuple(torch.as_tensor(t, device=dev) for t in (
        X[g, i * rows:(i + 1) * rows], S[g, i], R[g, i], W[g, i], y[g]))
