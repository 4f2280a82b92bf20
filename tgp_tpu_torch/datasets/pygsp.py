"""PyGSP-style standard graphs (port of ``tgp_tpu/datasets/pygsp.py``, a
numpy copy: the same graphs for a name, size and seed).

Each named graph is built in NumPy (no ``pygsp``).  Every graph returns
node coordinates as features, an undirected weighted edge list, and
labels (community ids for Community/StochasticBlockModel, zeros
otherwise).  The names that embed binary data files in pygsp (Logo,
Airfoil, Minnesota, Bunny, ImgPatches, Grid2dImgPatches, NNGraph) raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["PyGSPDataset", "pygsp_graph", "PYGSP_GRAPHS"]


def _from_dense(W):
    W = np.triu(W, 1)
    s, r = np.nonzero(W)
    w = W[s, r].astype(np.float32)
    ei = np.concatenate([np.stack([s, r]), np.stack([r, s])], 1)
    return ei.astype(np.int64), np.concatenate([w, w])


def _knn_graph(coords, k=6):
    d2 = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, 1)[:, :k]
    n = coords.shape[0]
    W = np.zeros((n, n))
    sigma = np.mean(np.sqrt(d2[np.arange(n)[:, None], idx])) + 1e-12
    for i in range(n):
        for j in idx[i]:
            W[i, j] = W[j, i] = np.exp(-d2[i, j] / (2 * sigma**2))
    return W


def _ring(n, rng):
    t = 2 * np.pi * np.arange(n) / n
    coords = np.stack([np.cos(t), np.sin(t)], 1)
    W = np.zeros((n, n))
    i = np.arange(n)
    W[i, (i + 1) % n] = W[(i + 1) % n, i] = 1.0
    return W, coords, None


def _path(n, rng):
    coords = np.stack([np.arange(n, dtype=float), np.zeros(n)], 1)
    W = np.zeros((n, n))
    i = np.arange(n - 1)
    W[i, i + 1] = W[i + 1, i] = 1.0
    return W, coords, None


def _grid2d(n, rng):
    side = max(2, int(np.sqrt(n)))
    xx, yy = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.stack([xx.ravel(), yy.ravel()], 1).astype(float)
    m = side * side
    W = np.zeros((m, m))
    for i in range(m):
        r, c = divmod(i, side)
        if c + 1 < side:
            W[i, i + 1] = W[i + 1, i] = 1.0
        if r + 1 < side:
            W[i, i + side] = W[i + side, i] = 1.0
    return W, coords, None


def _torus(n, rng):
    side = max(2, int(np.sqrt(n)))
    m = side * side
    W = np.zeros((m, m))
    for i in range(m):
        r, c = divmod(i, side)
        j = r * side + (c + 1) % side
        W[i, j] = W[j, i] = 1.0
        j = ((r + 1) % side) * side + c
        W[i, j] = W[j, i] = 1.0
    t = 2 * np.pi / side
    r_, c_ = np.divmod(np.arange(m), side)
    coords = np.stack([
        (2 + np.cos(r_ * t)) * np.cos(c_ * t),
        (2 + np.cos(r_ * t)) * np.sin(c_ * t),
        np.sin(r_ * t)], 1)
    return W, coords, None


def _full(n, rng):
    W = np.ones((n, n)) - np.eye(n)
    t = 2 * np.pi * np.arange(n) / n
    return W, np.stack([np.cos(t), np.sin(t)], 1), None


def _comet(n, rng, k=12):
    """k-star head + path tail (pygsp Comet)."""
    k = min(k, n - 1)
    W = np.zeros((n, n))
    for j in range(1, k + 1):
        W[0, j] = W[j, 0] = 1.0
    for j in range(k, n - 1):
        W[j, j + 1] = W[j + 1, j] = 1.0
    ang = 2 * np.pi * np.arange(n) / max(k, 1)
    coords = np.stack([np.arange(n, dtype=float), 0.3 * np.sin(ang)], 1)
    return W, coords, None


def _low_stretch_tree(n, rng):
    """Complete binary tree over ~n nodes."""
    depth = max(1, int(np.ceil(np.log2(n + 1))) - 1)
    m = 2 ** (depth + 1) - 1
    W = np.zeros((m, m))
    for i in range(1, m):
        p = (i - 1) // 2
        W[i, p] = W[p, i] = 1.0
    lvl = np.floor(np.log2(np.arange(m) + 1))
    pos = np.arange(m) + 1 - 2 ** lvl
    coords = np.stack([pos / np.maximum(2 ** lvl, 1), -lvl], 1)
    return W, coords, None


def _erdos_renyi(n, rng, p=0.1):
    upper = np.triu(rng.random((n, n)) < p, 1)
    W = (upper | upper.T).astype(float)
    return W, rng.normal(size=(n, 2)), None


def _barabasi_albert(n, rng, m=2):
    W = np.zeros((n, n))
    targets = list(range(m))
    repeated = list(range(m))
    for v in range(m, n):
        for t in targets:
            W[v, t] = W[t, v] = 1.0
        repeated.extend(targets)
        repeated.extend([v] * len(targets))
        targets = list({repeated[i] for i in
                        rng.integers(0, len(repeated), size=2 * m)})[:m]
        if not targets:
            targets = [int(rng.integers(0, v))]
    return W, rng.normal(size=(n, 2)), None


def _random_regular(n, rng, k=4):
    """Pairing-model k-regular graph (retry until simple)."""
    if (n * k) % 2 != 0:
        raise ValueError(
            f"k-regular graph needs n·k even, got n={n}, k={k}")
    if k >= n:
        raise ValueError(f"k-regular graph needs k < n, got n={n}, k={k}")
    for _ in range(200):
        stubs = np.repeat(np.arange(n), k)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        if (pairs[:, 0] == pairs[:, 1]).any():
            continue
        W = np.zeros((n, n))
        W[pairs[:, 0], pairs[:, 1]] = 1.0
        W = np.maximum(W, W.T)
        if (W.sum(1) == k).all():
            break
    else:
        # falling through would return a duplicate-collapsed graph with
        # degrees < k — the advertised regularity, violated silently
        raise RuntimeError(
            f"pairing model failed to produce a simple {k}-regular graph "
            f"on {n} nodes after 200 attempts")
    t = 2 * np.pi * np.arange(n) / n
    return W, np.stack([np.cos(t), np.sin(t)], 1), None


def _sbm(n, rng, n_com=3, p_in=0.3, p_out=0.02):
    com = np.sort(rng.integers(0, n_com, n))
    P = np.where(com[:, None] == com[None], p_in, p_out)
    upper = np.triu(rng.random((n, n)) < P, 1)
    W = (upper | upper.T).astype(float)
    ang = 2 * np.pi * com / n_com
    coords = np.stack([np.cos(ang), np.sin(ang)], 1) + \
        0.3 * rng.normal(size=(n, 2))
    return W, coords, com.astype(np.int64)


def _community(n, rng):
    return _sbm(n, rng, n_com=max(2, round(np.sqrt(n) / 2)),
                p_in=0.4, p_out=1.0 / n)


def _sensor(n, rng):
    coords = rng.random((n, 2))
    return _knn_graph(coords), coords, None


def _david_sensor(n, rng):
    coords = rng.random((n, 2))
    d2 = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    W = np.exp(-d2 / 0.02) * (d2 < 0.04)
    np.fill_diagonal(W, 0.0)
    return W, coords, None


def _swiss_roll(n, rng):
    t = 1.5 * np.pi * (1 + 2 * rng.random(n))
    h = 2 * rng.random(n) - 1
    coords = np.stack([t * np.cos(t), h * 10, t * np.sin(t)], 1) / 10
    return _knn_graph(coords), coords, None


def _sphere(n, rng):
    v = rng.normal(size=(n, 3))
    coords = v / np.linalg.norm(v, axis=1, keepdims=True)
    return _knn_graph(coords), coords, None


def _cube(n, rng):
    coords = rng.random((n, 3))
    face = rng.integers(0, 6, n)
    coords[np.arange(n), face % 3] = (face // 3).astype(float)
    return _knn_graph(coords), coords, None


def _two_moons(n, rng):
    half = n // 2
    t = np.pi * rng.random(half)
    a = np.stack([np.cos(t), np.sin(t)], 1)
    t2 = np.pi * rng.random(n - half)
    b = np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)
    coords = np.concatenate([a, b]) + 0.05 * rng.normal(size=(n, 2))
    lab = np.concatenate([np.zeros(half, np.int64),
                          np.ones(n - half, np.int64)])
    return _knn_graph(coords), coords, lab


def _random_ring(n, rng):
    t = np.sort(2 * np.pi * rng.random(n))
    coords = np.stack([np.cos(t), np.sin(t)], 1)
    W = np.zeros((n, n))
    i = np.arange(n)
    gap = np.diff(np.concatenate([t, [t[0] + 2 * np.pi]]))
    w = 1.0 / np.maximum(gap, 1e-6)
    W[i, (i + 1) % n] = w
    W = np.maximum(W, W.T)
    return W, coords, None


_CONSTRUCTORS = {
    "Graph": _erdos_renyi,  # generic fallback, like pygsp.graphs.Graph
    "Ring": _ring, "Path": _path, "Grid2d": _grid2d, "Torus": _torus,
    "FullConnected": _full, "Comet": _comet,
    "LowStretchTree": _low_stretch_tree, "ErdosRenyi": _erdos_renyi,
    "BarabasiAlbert": _barabasi_albert, "RandomRegular": _random_regular,
    "StochasticBlockModel": _sbm, "Community": _community,
    "Sensor": _sensor, "DavidSensorNet": _david_sensor,
    "SwissRoll": _swiss_roll, "Sphere": _sphere, "Cube": _cube,
    "TwoMoons": _two_moons, "RandomRing": _random_ring,
}

_UNAVAILABLE = {"Logo", "Airfoil", "Minnesota", "Bunny", "ImgPatches",
                "Grid2dImgPatches", "NNGraph"}

PYGSP_GRAPHS = sorted(_CONSTRUCTORS)


def pygsp_graph(name: str, n: int = 64, seed: int = 0, **kwargs):
    """Build a named standard graph.

    Returns ``(x, edge_index, edge_weight, y)`` with coordinates as
    features.
    """
    if name in _UNAVAILABLE:
        raise ValueError(
            f"Graph {name!r} embeds pygsp data files and is unavailable "
            f"without pygsp. Available graphs: {PYGSP_GRAPHS}")
    if name not in _CONSTRUCTORS:
        raise ValueError(
            f"Graph {name!r} not available. Available: {PYGSP_GRAPHS}")
    rng = np.random.default_rng(seed)
    W, coords, labels = _CONSTRUCTORS[name](n, rng, **kwargs)
    ei, w = _from_dense(W)
    m = W.shape[0]
    if labels is None:
        labels = np.zeros(m, np.int64)
    return (coords.astype(np.float32), ei, w.astype(np.float32),
            labels.astype(np.int32))


@dataclass
class PyGSPDataset:
    """Single-graph dataset over a named standard graph."""

    name: str = "Community"
    n: int = 64
    seed: int = 0
    kwargs: Optional[dict] = field(default=None)

    def load(self):
        return pygsp_graph(self.name, self.n, self.seed,
                           **(self.kwargs or {}))

    def as_graph_batch(self, device="cuda"):
        """The graph as the port's one-graph
        :class:`~tgp_tpu_torch.graph.GraphBatch` on ``device``."""
        from tgp_tpu_torch.graph import from_graphs

        x, ei, w, _ = self.load()
        return from_graphs([(x, ei, w)], device=device)
