"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that this module reads.

A request (or a training batch) is a list of ``(x, edge_index)`` numpy
graphs made from ``(seed, stream, index)`` alone, so the same seed gives
the same inputs in every run and the reference can make them again.

Parameters of a mix:

* ``graphs_per_request``: graphs in one request or training batch.
* ``nodes``: ``{"dist": "fixed", "value": n}``, or ``{"dist":
  "lognormal", "mean", "sigma_log", "min", "max", "pool_requests",
  "pool_seed"}``: a pool of node counts drawn once from ``pool_seed``
  (the same for every run seed), which each run seed deals out in an
  order of its own, so every seed serves the same set of sizes.
* ``edges``: ``{"kind": "uniform_directed", "count": m}`` (m directed
  edges with both ends uniform; repeats and loops as drawn),
  ``{"kind": "er_undirected", "p": p}`` (Erdős–Rényi, both directions),
  or ``{"kind": "undirected_mean_degree", "mean_degree": d}``
  (round(n·d/2) uniform pairs of distinct nodes, both directions).
* ``features``: width of the normal node features.
* ``labels`` (training): ``{"kind": "fixed", "value": c}`` or
  ``{"kind": "uniform", "classes": c}``.
"""

from __future__ import annotations

import math

import numpy as np

#: streams of one seed: the measured requests, the warm-up requests, the
#: training batch and its labels, and the order of a size pool
WINDOW, WARMUP, TRAIN, LABELS, ORDER, SAMPLE = range(6)


def seed64(seed: int) -> int:
    """The seed as an unsigned 64-bit number (negative seeds wrap)."""
    return int(seed) & (2 ** 64 - 1)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed64(seed), *stream])


def _pool(nodes: dict, gpr: int) -> np.ndarray:
    sigma = float(nodes["sigma_log"])
    mu = math.log(float(nodes["mean"])) - sigma ** 2 / 2  # mean as given
    draw = np.random.default_rng(int(nodes["pool_seed"])).lognormal(
        mu, sigma, int(nodes["pool_requests"]) * gpr)
    return np.clip(np.rint(draw), nodes["min"], nodes["max"]).astype(np.int64)


def node_counts(traffic: dict, seed: int, i: int) -> list:
    """Node count of each graph of request ``i`` (the same in every
    stream: a warm-up request of index ``i`` has the sizes of the measured
    one)."""
    gpr = int(traffic["graphs_per_request"])
    nodes = traffic["nodes"]
    if nodes["dist"] == "fixed":
        return [int(nodes["value"])] * gpr
    if nodes["dist"] != "lognormal":
        raise ValueError(f"unknown node distribution {nodes['dist']!r}")
    pool = _pool(nodes, gpr)
    n_req = len(pool) // gpr
    order = rng(seed, ORDER).permutation(n_req)
    j = int(order[i % n_req])
    return [int(n) for n in pool[j * gpr:(j + 1) * gpr]]


def _edges(g: np.random.Generator, n: int, edges: dict) -> np.ndarray:
    kind = edges["kind"]
    if kind == "uniform_directed":
        m = int(edges["count"])
        s = g.integers(0, n, m)
        r = g.integers(0, n, m)
        return np.stack([s, r])
    if kind == "er_undirected":
        upper = np.triu(g.random((n, n)) < float(edges["p"]), k=1)
        s, r = np.nonzero(upper | upper.T)
        return np.stack([s, r]).astype(np.int64)
    if kind == "undirected_mean_degree":
        m = int(round(n * float(edges["mean_degree"]) / 2))
        a = g.integers(0, n, m)
        b = (a + g.integers(1, n, m)) % n  # never a loop
        return np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    raise ValueError(f"unknown edge kind {kind!r}")


def edge_count(traffic: dict, n: int):
    """Edges of a graph of ``n`` nodes where the kind fixes them, else
    None."""
    edges = traffic["edges"]
    if edges["kind"] == "uniform_directed":
        return int(edges["count"])
    if edges["kind"] == "undirected_mean_degree":
        return 2 * int(round(n * float(edges["mean_degree"]) / 2))
    return None


def graphs(traffic: dict, seed: int, i: int, stream: int = WINDOW,
           rep: int = 0) -> list:
    """Request ``i`` of the stream (``rep``: another draw of the same
    sizes): ``[(x [n, F] f32, edge_index [2, m] int64), ...]``."""
    F = int(traffic["features"])
    out = []
    for j, n in enumerate(node_counts(traffic, seed, i)):
        g = rng(seed, stream, i, rep, j)
        ei = _edges(g, n, traffic["edges"])
        x = g.standard_normal((n, F), dtype=np.float32)
        out.append((x, ei))
    return out


def labels(traffic: dict, seed: int, n: int) -> np.ndarray:
    spec = traffic["labels"]
    if spec["kind"] == "fixed":
        return np.full(n, int(spec["value"]), dtype=np.int64)
    if spec["kind"] == "uniform":
        return rng(seed, LABELS).integers(0, int(spec["classes"]), n)
    raise ValueError(f"unknown label kind {spec['kind']!r}")
