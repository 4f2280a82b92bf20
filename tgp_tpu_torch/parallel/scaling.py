"""Scaling harness: edges/s of the sharded pooled forward against the rank
count (port of ``tgp_tpu/parallel/scaling.py``).  Every rank of the world
calls :func:`measure_pooled_scaling`; for each ``D`` the first ``D`` ranks
run the forward on a mesh of their own and the others wait.  On one card
only ``D = 1`` runs; CPU ranks under gloo check the machinery, and their
times are not device numbers."""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tgp_tpu_torch.parallel._collectives import local_shard
from tgp_tpu_torch.parallel.pooled_model import (init_pooled_params,
                                                 make_sharded_pooled_forward,
                                                 prepare_sharded_graph)

__all__ = ["measure_pooled_scaling"]


def _random_regular_graph(n: int, degree: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    senders = np.repeat(np.arange(n), degree)
    receivers = rng.integers(0, n, senders.shape[0])
    keep = senders != receivers
    s, r = senders[keep], receivers[keep]
    return (np.concatenate([s, r]).astype(np.int64),
            np.concatenate([r, s]).astype(np.int64))


def _time_s(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls after a warm one:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def measure_pooled_scaling(
    n_nodes: int = 1 << 16,
    n_feats: int = 64,
    degree: int = 8,
    hidden: int = 64,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    iters: int = 10,
    seed: int = 0,
) -> Dict[int, dict]:
    """Run the sharded GCN → pool → GCN forward on the first ``D`` ranks for
    each ``D`` in ``device_counts`` (a ``D`` larger than the world is
    skipped), on the same graph; returns ``{D: {edges_per_s,
    seconds_per_step, efficiency}}`` for each ``D`` this rank took part in
    (rank 0 takes part in all), efficiency relative to the first ``D``'s
    throughput (ideal 1.0)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("measure_pooled_scaling runs on every rank of a "
                           "process group; none is initialized")
    world, me = dist.get_world_size(), dist.get_rank()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    s_np, r_np = _random_regular_graph(n_nodes, degree, seed)
    n_edges = s_np.shape[0]
    x_np = np.random.default_rng(seed + 1).normal(
        size=(n_nodes, n_feats)).astype(np.float32)

    results: Dict[int, dict] = {}
    base = None
    for D in device_counts:
        if D > world:
            continue
        # every rank joins the sub-mesh's groups; only its ranks run
        mesh = DeviceMesh(device_type, torch.arange(D),
                          mesh_dim_names=("gp",))
        if me >= D:
            continue
        group = mesh.get_group("gp")
        S, R, W, n_pad, rows_per = prepare_sharded_graph(
            s_np, r_np, None, n_nodes, D, device=device)
        x = np.zeros((n_pad, n_feats), np.float32)
        x[:n_nodes] = x_np
        x_local = local_shard(torch.as_tensor(x, device=device), group)
        params = init_pooled_params(torch.Generator().manual_seed(0),
                                    n_feats, hidden, 3, device=device)
        fwd, _ = make_sharded_pooled_forward(
            mesh, rows_per=rows_per, n_pad=n_pad, num_valid=n_nodes,
            ratio=0.5)
        S_d, R_d, W_d = (t[dist.get_rank(group)] for t in (S, R, W))

        def run():
            with torch.no_grad():
                return fwd(params, x_local, S_d, R_d, W_d)

        dt = _time_s(run, iters, device)
        eps = n_edges / dt
        if base is None:
            base = eps
        results[D] = {
            "edges_per_s": eps,
            "seconds_per_step": dt,
            "efficiency": eps / (base * (D / device_counts[0])),
        }
    return results
