"""Graclus level function: heaviest-first greedy matching on the host (port
of ``tgp_tpu/precoarsen/graclus.py``).  The matching runs in the native
library (:mod:`tgp_tpu_torch._native`) where a C++ compiler is found, else
in its numpy twin :func:`graclus_matching_numpy`: the same clusters."""

from __future__ import annotations

import numpy as np

from tgp_tpu_torch import _native
from tgp_tpu_torch.precoarsen.common import coalesce_numpy

__all__ = ["graclus_matching_numpy", "graclus_level"]


def graclus_matching_numpy(edge_index, num_nodes, edge_weight=None,
                           seed: int = 0) -> np.ndarray:
    """Greedy matching over the edges, heaviest first (ties by the
    ``(min, max)`` endpoint pair): ``cluster [n]`` with consecutive ids,
    matched pairs first (in match order), then singletons.  ``seed`` is
    kept for the native function's signature and ignored."""
    del seed
    ei = np.asarray(edge_index, np.int64)
    s, r = ei[0], ei[1]
    w = (np.ones(s.size) if edge_weight is None
         else np.asarray(edge_weight, np.float64))
    lo, hi = np.minimum(s, r), np.maximum(s, r)
    order = np.lexsort((hi, lo, -w))
    cluster = np.full(num_nodes, -1, np.int64)
    next_id = 0
    for i in order:
        u, v = s[i], r[i]
        if u == v or cluster[u] >= 0 or cluster[v] >= 0:
            continue
        cluster[u] = cluster[v] = next_id
        next_id += 1
    unmatched = cluster < 0
    cluster[unmatched] = next_id + np.arange(int(unmatched.sum()))
    return cluster


def graclus_level(edge_index, num_nodes, edge_weight=None, *,
                  seed: int = 0) -> dict:
    """One Graclus level: a total (``partial=False``) sparse assignment of
    every node to its matched pair or itself, and the pooled edges
    (self-loops dropped, duplicates summed)."""
    if _native.available():
        cluster = _native.native_graclus_matching(edge_index, num_nodes,
                                                  edge_weight, seed)
        _native.note_engine("native")
    else:
        cluster = graclus_matching_numpy(edge_index, num_nodes, edge_weight,
                                         seed)
        _native.note_engine("numpy")
    k = int(cluster.max()) + 1 if num_nodes else 0
    ei = np.asarray(edge_index)
    w = (np.ones(ei.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    pooled = np.stack([cluster[ei[0]], cluster[ei[1]]])
    keep = pooled[0] != pooled[1]
    ei_pool, ew_pool = coalesce_numpy(pooled[:, keep], w[keep], max(k, 1))
    return {
        "kind": "sparse",
        "cluster_index": cluster,
        "weight": np.ones(num_nodes, np.float32),
        "num_clusters": k,
        "edge_index": ei_pool,
        "edge_weight": ew_pool.astype(np.float32),
        "partial": False,
    }
