"""Sharded end-to-end pooled-model forward for large single graphs (port
of ``tgp_tpu/parallel/pooled_model.py``): GCN → (distributed exact top-k
→ repartition → coarse GCN) × levels → sum readout → linear head.

* rank ``d`` owns rows ``[d·rows_per, (d+1)·rows_per)`` of ``x``; edges
  are partitioned by receiver owner (:func:`~tgp_tpu_torch.parallel.spmm.
  partition_edges`);
* the first GCN layer is the edge-partitioned SpMM: an ``all_gather`` of
  the feature shard, then this rank's sum on K1 (``spmm_csr``);
* top-k: scores are computed locally, gathered (``[N]`` floats) and
  ranked by a stable sort, the same on every rank; the node of global
  rank ``t`` becomes supernode ``t < K``, owned by rank ``t // (K/D)``;
* coarse GCN: every rank relabels its own edges through the rank table,
  sums its messages into the full ``[K, H]`` coarse row space (a gather
  whose gradient is fixed-order, then K4 after a stable sort) and the
  partial sums are added over the ranks in rank order (``psum``);
* readout: the sum over the supernodes.

Collectives follow :mod:`~tgp_tpu_torch.parallel._collectives`' gradient
convention; :func:`reference_pooled_forward` is the single-device twin.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.segment import gather_rows, segment_sum
from tgp_tpu_torch.parallel._collectives import (all_gather_rows,
                                                 group_rank, group_size,
                                                 psum)
from tgp_tpu_torch.parallel.spmm import (CsrLayout, _LayoutCache,
                                         partition_edges)

__all__ = ["init_pooled_params", "make_sharded_pooled_forward",
           "reference_pooled_forward", "prepare_sharded_graph", "level_ks"]


def level_ks(num_valid: int, ratio: float, num_levels: int,
             n_devices: int):
    """Per-level supernode counts: ``ceil(ratio·n)`` rounded up to a
    multiple of the rank count; shared by the sharded forward and the
    hybrid train step so that both build the same model."""
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1 (a pool-free GCN has no "
                         "pooled readout path here)")
    ks = []
    cur = num_valid
    for _ in range(num_levels):
        k = max(int(math.ceil(ratio * cur)), 1)
        k = ((k + n_devices - 1) // n_devices) * n_devices
        ks.append(k)
        cur = k
    return tuple(ks)


def _glorot(generator, shape, device):
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.rand(shape, generator=generator) * (2 * limit) - limit
    return w.to(device)


def init_pooled_params(generator: torch.Generator, in_features: int,
                       hidden: int, num_classes: int, num_levels: int = 1,
                       *, device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The model's parameters, drawn from ``generator`` (a CPU generator;
    Glorot-uniform matrices, zero biases, ``p{l}`` uniform in ``±1/√hidden``)
    as leaf tensors that require a gradient, with JAX's keys in JAX's
    order: ``W1 b1 Wh bh``, then ``p{l} W{l+2} b{l+2}`` for each level."""
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(hidden)
    params = {
        "W1": _glorot(generator, (in_features, hidden), dev),
        "b1": torch.zeros(hidden, device=dev),
        "Wh": _glorot(generator, (hidden, num_classes), dev),
        "bh": torch.zeros(num_classes, device=dev),
    }
    for lvl in range(num_levels):
        params[f"p{lvl}"] = (torch.rand(hidden, generator=generator)
                             * (2 * bound) - bound).to(dev)
        params[f"W{lvl + 2}"] = _glorot(generator, (hidden, hidden), dev)
        params[f"b{lvl + 2}"] = torch.zeros(hidden, device=dev)
    return {k: v.requires_grad_() for k, v in params.items()}


def prepare_sharded_graph(senders, receivers, edge_weight, num_nodes: int,
                          n_devices: int, *, device: DeviceLike = "cuda"):
    """Host-side prep: GCN-normalize (A+I) edge weights, then partition by
    receiver owner.  Returns ``(S, R, W [D, E_local], n_pad, rows_per)``
    with ``R`` in local and ``S`` in global row coordinates (the same
    arrays as JAX's)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    w = (np.ones(senders.shape[0], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    loops = np.arange(num_nodes)
    s_all = np.concatenate([senders, loops])
    r_all = np.concatenate([receivers, loops])
    w_all = np.concatenate([w, np.ones(num_nodes, np.float32)])
    deg = np.zeros(num_nodes, np.float32)
    np.add.at(deg, s_all, w_all)
    dinv = 1.0 / np.sqrt(np.clip(deg, 1e-12, None))
    w_all = w_all * dinv[s_all] * dinv[r_all]
    return partition_edges(s_all, r_all, w_all, num_nodes, n_devices,
                           device=device)


def _coarse_gcn(xp, W, s, r, w, k):
    """``[k, H]`` sums ``Σ_{e: r_e = t} w_e · (xp W)[s_e]``, fixed-order: a
    ``gather_rows`` (its gradient sorts ``s``), then K4 after a stable sort
    of ``r``."""
    msgs = gather_rows(xp @ W, s, k) * w[:, None]
    return segment_sum(msgs, r, k)


def _forward_local(params, x_local, S_d, R_d, W_d, *, rows_per: int,
                   num_valid: int, ks, group,
                   layout: Optional[CsrLayout] = None):
    """Per-rank body (every rank of ``group`` calls it with its shard):
    ``(logits [C] replicated, h [K_last/D, H] sharded)``.  ``ks``: the
    per-level supernode counts, each a multiple of the rank count;
    ``layout``: the K1 layout of ``S_d``/``R_d`` (made when not given)."""
    d = group_rank(group)
    n_dev = group_size(group)
    dev = x_local.device

    # ---- GCN layer 1: the edge-partitioned SpMM on K1 ---------------------
    h_full = all_gather_rows(x_local @ params["W1"], group)  # [n_pad, H]
    if layout is None:
        layout = CsrLayout(S_d, R_d, rows_per, h_full.shape[0])
    h = torch.relu(layout.spmm(h_full, W_d) + params["b1"])

    # edge endpoints in GLOBAL coordinates (relabelled at every level)
    s_glob = S_d.long()
    r_glob = d * rows_per + R_d.long()
    w_e = W_d
    cur_valid, cur_rows = num_valid, rows_per
    h_glob = None

    for level, k_total in enumerate(ks):
        k_per = k_total // n_dev
        # ---- distributed exact top-k select ------------------------------
        p = params[f"p{level}"]
        score_local = torch.tanh(
            (h @ p) / torch.clamp(torch.linalg.vector_norm(p), min=1e-12))
        # padding rows are never selected: -inf by global position
        pos = d * cur_rows + torch.arange(cur_rows, device=dev)
        score_local = torch.where(pos < cur_valid, score_local,
                                  float("-inf"))
        score = all_gather_rows(score_local, group)
        order = torch.argsort(-score, stable=True)  # the same on every rank
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=dev)
        kept_ids = order[:k_total]

        # ---- repartition: rank d owns supernodes [d·k_per, ...) ----------
        h_full = all_gather_rows(h, group)
        my_ids = kept_ids[d * k_per:(d + 1) * k_per]  # distinct ids
        gate = score[my_ids]
        # a k rounded up to a rank multiple can exceed the valid nodes: the
        # -inf gates of padding picks become 0 so the backward stays finite
        gate = torch.where(torch.isfinite(gate), gate, 0.0)
        xp_local = h_full[my_ids] * gate[:, None]  # [k_per, H]

        # ---- coarse connect: relabel this rank's edges --------------------
        new_s, new_r = rank[s_glob], rank[r_glob]
        keep = (new_s < k_total) & (new_r < k_total) & (w_e != 0)
        w_e = torch.where(keep, w_e, 0.0)
        s_glob = torch.where(keep, new_s, 0)
        r_glob = torch.where(keep, new_r, 0)

        # ---- coarse GCN: local partial sums + psum -------------------------
        xp_full = all_gather_rows(xp_local, group)  # [K, H]
        part = _coarse_gcn(xp_full, params[f"W{level + 2}"], s_glob, r_glob,
                           w_e, k_total)
        h_glob = torch.relu(psum(part, group) + params[f"b{level + 2}"])
        h = h_glob[d * k_per:(d + 1) * k_per]
        cur_valid, cur_rows = k_total, k_per

    # ---- readout (single graph): sum over supernodes → logits -----------
    z = h_glob.sum(0)
    return z @ params["Wh"] + params["bh"], h


def make_sharded_pooled_forward(mesh, *, rows_per: int, n_pad: int,
                                num_valid: int | None = None,
                                ratio: float = 0.5, num_levels: int = 1,
                                axis: str = "gp"):
    """The sharded GCN → (top-k pool → coarse GCN) × ``num_levels`` →
    readout forward on ``mesh``'s ``axis``: ``(fn, ks)``, ``fn(params,
    x_local [rows_per, F], S_d, R_d, W_d [E_local]) → (logits [C],
    h [K_last/D, H])`` on every rank, ``ks`` the per-level supernode
    counts.  The K1 layout of a partition is made at its first call."""
    group = mesh.get_group(axis)
    n_devices = group_size(group)
    if n_pad != rows_per * n_devices:
        raise ValueError(f"n_pad={n_pad} is not rows_per·D = "
                         f"{rows_per}·{n_devices}")
    if num_valid is None:
        num_valid = n_pad
    ks = level_ks(num_valid, ratio, num_levels, n_devices)
    cache = _LayoutCache(lambda s, r: CsrLayout(s, r, rows_per, n_pad))

    def fn(params, x_local, S_d, R_d, W_d):
        return _forward_local(params, x_local, S_d, R_d, W_d,
                              rows_per=rows_per, num_valid=num_valid, ks=ks,
                              group=group, layout=cache(S_d, R_d))

    return fn, ks


def reference_pooled_forward(params, x, senders, receivers, edge_weight,
                             num_nodes: int, ks, num_valid=None):
    """Single-device twin of the same multi-level forward (``ks`` from
    :func:`make_sharded_pooled_forward`), every sum fixed-order
    (``segment_sum``, ``gather_rows``); on ``x``'s device."""
    dev = x.device
    n_pad = x.shape[0]
    if num_valid is None:
        num_valid = num_nodes
    senders = torch.as_tensor(senders, device=dev).long()
    receivers = torch.as_tensor(receivers, device=dev).long()
    loops = torch.arange(num_nodes, device=dev)
    s_all = torch.cat([senders, loops])
    r_all = torch.cat([receivers, loops])
    w = (torch.ones(senders.shape[0], device=dev) if edge_weight is None
         else torch.as_tensor(edge_weight, device=dev).float())
    w_all = torch.cat([w, torch.ones(num_nodes, device=dev)])
    deg = segment_sum(w_all, s_all, num_nodes)
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
    w_all = w_all * dinv[s_all] * dinv[r_all]

    h = segment_sum(gather_rows(x @ params["W1"], s_all, n_pad)
                    * w_all[:, None], r_all, n_pad)
    h = torch.relu(h + params["b1"])
    s_cur, r_cur, w_cur = s_all, r_all, w_all
    cur_valid = num_valid
    h_glob = None
    for level, k in enumerate(ks):
        p = params[f"p{level}"]
        score = torch.tanh(
            (h @ p) / torch.clamp(torch.linalg.vector_norm(p), min=1e-12))
        score = torch.where(torch.arange(h.shape[0], device=dev) < cur_valid,
                            score, float("-inf"))
        order = torch.argsort(-score, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=dev)
        kept = order[:k]
        gate = score[kept]
        gate = torch.where(torch.isfinite(gate), gate, 0.0)
        xp = h[kept] * gate[:, None]
        new_s, new_r = rank[s_cur], rank[r_cur]
        keep = (new_s < k) & (new_r < k) & (w_cur != 0)
        s_cur = torch.where(keep, new_s, 0)
        r_cur = torch.where(keep, new_r, 0)
        w_cur = torch.where(keep, w_cur, 0.0)
        agg = _coarse_gcn(xp, params[f"W{level + 2}"], s_cur, r_cur, w_cur,
                          k)
        h_glob = torch.relu(agg + params[f"b{level + 2}"])
        h = h_glob
        cur_valid = k
    z = h_glob.sum(0)
    return z @ params["Wh"] + params["bh"], h_glob
