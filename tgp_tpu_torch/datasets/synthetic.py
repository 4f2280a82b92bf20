"""Synthetic graph classification (port of
``tgp_tpu/datasets/synthetic.py::SyntheticGraphClassification``): numpy
generators, the same graphs and labels as the JAX package's for a seed."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = ["SyntheticGraphClassification"]


def _er_graph(rng, n, p):
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = upper | upper.T
    s, r = np.nonzero(adj)
    return np.stack([s, r])


def _ba_graph(rng, n, m):
    """Barabási–Albert preferential attachment."""
    targets = list(range(m))
    repeated: List[int] = []
    edges = set()
    for v in range(m, n):
        for t in targets:
            edges.add((v, t))
            edges.add((t, v))
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = list(rng.choice(repeated, size=m))
    if not edges:
        edges = {(0, 1), (1, 0)}
    ei = np.array(sorted(edges)).T
    return ei


def _ring_lattice(rng, n, k):
    edges = set()
    for i in range(n):
        for d in range(1, k // 2 + 1):
            j = (i + d) % n
            edges.add((i, j))
            edges.add((j, i))
    return np.array(sorted(edges)).T


@dataclass
class SyntheticGraphClassification:
    """Three-class structural classification (graph ``i`` is ER, BA or a
    ring lattice by ``i % 3``).  Node features: the degree over the
    graph's largest degree, then normal noise; learnable by message
    passing, pooling and a readout, not from the feature means alone."""

    num_graphs: int = 300
    min_nodes: int = 20
    max_nodes: int = 60
    num_features: int = 8
    num_classes: int = 3
    seed: int = 0

    def generate(self) -> Tuple[list, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        graphs, labels = [], []
        for i in range(self.num_graphs):
            cls = i % self.num_classes
            n = int(rng.integers(self.min_nodes, self.max_nodes + 1))
            if cls == 0:
                ei = _er_graph(rng, n, p=4.0 / n)
                if ei.shape[1] == 0:
                    ei = np.array([[0, 1], [1, 0]])
            elif cls == 1:
                ei = _ba_graph(rng, n, m=2)
            else:
                ei = _ring_lattice(rng, n, k=4)
            deg = np.bincount(ei[0], minlength=n).astype(np.float32)
            feats = [deg[:, None]]
            feats.append(rng.normal(size=(n, self.num_features - 1))
                         .astype(np.float32))
            x = np.concatenate(feats, axis=1).astype(np.float32)
            x[:, 0] = x[:, 0] / max(deg.max(), 1.0)
            graphs.append((x, ei))
            labels.append(cls)
        return graphs, np.asarray(labels, np.int32)
