"""Edge-partitioned SpMM across the ranks of a process group (port of
``tgp_tpu/parallel/spmm.py``).

Nodes are sharded in contiguous ranges (rank *d* owns rows ``[d·N/D,
(d+1)·N/D)`` of ``x``); edges are partitioned by the receiver's owner, so
the sum of ``A·X`` is local; remote sender rows arrive by an
``all_gather`` over the axis (:func:`sharded_spmm`), or rotate around a
ring with ``ppermute`` (:func:`make_ring_halo_spmm`), whose peak memory is
``O(rows_per·F)`` instead of ``O(N·F)``.

``shard_map`` becomes SPMD over the ranks of a ``torch.distributed``
process group: every rank calls the same function with its own shard
(:func:`~tgp_tpu_torch.parallel._collectives.local_shard` cuts it from a
global array).  The local sum runs K1 (``spmm_csr``) over a
receiver-sorted CSR layout of the rank's partition, with its
sender-sorted transpose for the gradient (:class:`CsrLayout`, made once
per graph); on CPU tensors K1's plain version runs.  The host-side
partitions are numpy copies of JAX's and give the same arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.kernels.segment_spmm import csr_layouts
from tgp_tpu_torch.parallel._collectives import (all_gather_rows,
                                                 group_size, ppermute)

__all__ = ["partition_edges", "sharded_spmm", "make_sharded_spmm",
           "partition_edges_2d", "make_ring_halo_spmm",
           "balanced_node_order", "CsrLayout"]


def _ceil_to(v, m):
    return ((v + m - 1) // m) * m


def _tensors(device, *arrays):
    dev = resolve_device(device)
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def partition_edges(senders, receivers, edge_weight, num_nodes: int,
                    n_devices: int, *, device: DeviceLike = "cuda"):
    """Host-side partition: edges grouped by receiver's owner, padded to a
    common per-rank budget (a multiple of 8; padding ``s = r = 0, w =
    0``).  Returns ``(S, R, W [D, E_local], n_pad, rows_per)``, ``S`` in
    global and ``R`` in local row coordinates, as tensors on ``device``
    (int32, int32, float32)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_weight = np.asarray(edge_weight)
    n_pad = _ceil_to(num_nodes, n_devices)
    rows_per = n_pad // n_devices
    owner = receivers // rows_per

    buckets = [np.nonzero(owner == d)[0] for d in range(n_devices)]
    e_local = _ceil_to(max(max(len(b) for b in buckets), 1), 8)
    S = np.zeros((n_devices, e_local), np.int32)
    R = np.zeros((n_devices, e_local), np.int32)
    W = np.zeros((n_devices, e_local), np.float32)
    for d, idx in enumerate(buckets):
        k = len(idx)
        S[d, :k] = senders[idx]
        R[d, :k] = receivers[idx] - d * rows_per  # local row index
        W[d, :k] = edge_weight[idx]
    return _tensors(device, S, R, W) + (n_pad, rows_per)


class CsrLayout:
    """One rank's edges ``(senders into [n_src] rows, receivers into
    [num_rows] rows)`` in K1's two layouts
    (:func:`~tgp_tpu_torch.ops.kernels.segment_spmm.csr_layouts`):
    receiver-sorted with ``row_ptr`` (the forward) and sender-sorted with
    ``row_ptr_t`` (the gradient for ``x``); ``order`` and ``order_t`` take
    an edge array of the input order into each.  Both sorts are stable,
    so padding edges (``s = r = 0, w = 0``) keep their order and add zero
    to row 0."""

    def __init__(self, senders: torch.Tensor, receivers: torch.Tensor,
                 num_rows: int, n_src: int):
        csr = csr_layouts(senders.to(torch.int32),
                          receivers.to(torch.int32), num_rows, n_src)
        self.num_rows, self.n_src = num_rows, n_src
        self.order, self.order_t = csr.order, csr.order[csr.perm]
        self.senders, self.receivers = csr.senders, csr.receivers
        self.senders_t, self.receivers_t = csr.senders_t, csr.receivers_t
        self.row_ptr, self.row_ptr_t = csr.row_ptr, csr.row_ptr_t

    def spmm(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """``out[r] = Σ_{e: recv=r} w_e · x[send_e]`` on K1 (``[num_rows,
        F]`` in ``x.dtype``); differentiable in ``x`` and ``weight``."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

        if x.shape[0] != self.n_src:
            raise ValueError(f"x has {x.shape[0]} rows, the layout "
                             f"{self.n_src}")
        w = weight.to(torch.float32)
        return spmm_csr(x.contiguous(), w[self.order].contiguous(),
                        w[self.order_t].contiguous(), self.senders,
                        self.receivers, self.row_ptr, self.receivers_t,
                        self.senders_t, self.row_ptr_t, self.num_rows)


class _LayoutCache:
    """The last layouts made, by the identity and version of the edge
    tensors they came from (a graph's layout is made once)."""

    def __init__(self, make: Callable):
        self._make = make
        self._key, self._keep, self._value = None, None, None

    def __call__(self, *tensors):
        key = tuple((id(t), t._version) for t in tensors)
        if key != self._key:
            self._value = self._make(*tensors)
            # the tensors are held so that their ids are not reused
            self._key, self._keep = key, tensors
        return self._value


def sharded_spmm(x_local: torch.Tensor, senders_d: torch.Tensor,
                 receivers_local_d: torch.Tensor, weight_d: torch.Tensor,
                 rows_per: int, group, *,
                 layout: Optional[CsrLayout] = None) -> torch.Tensor:
    """Per-rank body: gather the full ``X`` over the group, then the local
    sum of this rank's partition (``S/R/W [E_local]``, a row of
    :func:`partition_edges`) on K1.  ``layout`` (:class:`CsrLayout` of
    ``senders_d``/``receivers_local_d``) is made here when not given."""
    x_full = all_gather_rows(x_local, group)  # [n_pad, F]
    if layout is None:
        layout = CsrLayout(senders_d, receivers_local_d, rows_per,
                           x_full.shape[0])
    return layout.spmm(x_full, weight_d)


def make_sharded_spmm(mesh, rows_per: int, axis: str = "gp"):
    """The sharded SpMM on ``mesh``'s ``axis``: ``fn(x_local [rows_per,
    F], S_d, R_d, W_d [E_local])`` → this rank's rows of ``A·X``.  The K1
    layout of a partition is made at its first call and kept."""
    group = mesh.get_group(axis)
    n_pad = rows_per * group_size(group)
    cache = _LayoutCache(lambda s, r: CsrLayout(s, r, rows_per, n_pad))

    def fn(x_local, S_d, R_d, W_d):
        return sharded_spmm(x_local, S_d, R_d, W_d, rows_per, group,
                            layout=cache(S_d, R_d))

    return fn


def partition_edges_2d(senders, receivers, edge_weight, num_nodes: int,
                       n_devices: int, *, device: DeviceLike = "cuda"):
    """Host-side 2-D partition for the ring-halo variant: edges bucketed
    by ``(receiver_owner, sender_owner)`` so that at ring step ``k`` rank
    ``d`` processes its edges whose senders live in the shard it holds
    (origin ``(d − k) mod D``).  Returns ``[D, D, E_local]`` tensors
    (senders local to their shard, receivers local to ``d``) and the
    padding metadata."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_weight = np.asarray(edge_weight)
    n_pad = _ceil_to(num_nodes, n_devices)
    rows_per = n_pad // n_devices
    r_owner = receivers // rows_per
    s_owner = senders // rows_per

    buckets = {}
    e_local = 1
    for d in range(n_devices):
        for k in range(n_devices):
            src_shard = (d - k) % n_devices
            idx = np.nonzero((r_owner == d) & (s_owner == src_shard))[0]
            buckets[(d, k)] = idx
            e_local = max(e_local, len(idx))
    e_local = _ceil_to(e_local, 8)
    S = np.zeros((n_devices, n_devices, e_local), np.int32)
    R = np.zeros((n_devices, n_devices, e_local), np.int32)
    W = np.zeros((n_devices, n_devices, e_local), np.float32)
    for (d, k), idx in buckets.items():
        m = len(idx)
        src_shard = (d - k) % n_devices
        S[d, k, :m] = senders[idx] - src_shard * rows_per  # local in shard
        R[d, k, :m] = receivers[idx] - d * rows_per
        W[d, k, :m] = edge_weight[idx]
    return _tensors(device, S, R, W) + (n_pad, rows_per)


def make_ring_halo_spmm(mesh, rows_per: int, n_devices: int,
                        axis: str = "gp"):
    """Ring-halo SpMM: ``fn(x_local [rows_per, F], S_d, R_d, W_d [D,
    E_local])``.  Each rank's shard rotates around the ring with
    ``ppermute`` (D − 1 sends of ``[rows_per, F]``; none at D = 1) while
    every rank adds the contribution of the shard it holds, step by step
    in ring order, each on K1."""
    group = mesh.get_group(axis)
    if group_size(group) != n_devices:
        raise ValueError(f"n_devices={n_devices} but the axis {axis!r} has "
                         f"{group_size(group)} ranks")
    cache = _LayoutCache(lambda S, R: [
        CsrLayout(S[k], R[k], rows_per, rows_per) for k in range(n_devices)])

    def fn(x_local, S_d, R_d, W_d):
        layouts = cache(S_d, R_d)
        x_shard, acc = x_local, None
        for k in range(n_devices):
            part = layouts[k].spmm(x_shard, W_d[k])
            acc = part if acc is None else acc + part
            if k + 1 < n_devices:
                x_shard = ppermute(x_shard, group, 1)
        return acc

    return fn


def balanced_node_order(receivers, num_nodes: int, n_devices: int,
                        senders=None, *, device: DeviceLike = "cuda"):
    """Degree-aware row partitioning (greedy LPT bin-packing on weighted
    degree): ``(perm, inv)`` int64 tensors on ``device``, ``perm[new] =
    old`` node id and ``inv[old] = new``, such that partitioning the
    relabelled graph into contiguous equal-row ranges balances the
    per-rank edge loads.  The same arrays as JAX's."""
    receivers = np.asarray(receivers)
    n_pad = _ceil_to(num_nodes, n_devices)
    rows_per = n_pad // n_devices
    deg = np.bincount(receivers, minlength=n_pad).astype(np.int64)
    if senders is not None:
        deg = deg + np.bincount(np.asarray(senders), minlength=n_pad)
    order = np.argsort(-deg, kind="stable")  # heaviest first
    load = np.zeros(n_devices, np.int64)
    slots = np.full(n_devices, rows_per, np.int64)
    perm = np.empty(n_pad, np.int64)
    cursor = np.arange(n_devices) * rows_per  # next row slot per rank
    for node in order:
        free = slots > 0
        d = int(np.flatnonzero(free)[np.argmin(load[free])])
        perm[cursor[d]] = node
        cursor[d] += 1
        slots[d] -= 1
        load[d] += deg[node]
    inv = np.empty(n_pad, np.int64)
    inv[perm] = np.arange(n_pad)
    return _tensors(device, perm, inv)
