"""Multipartite graph dataset (port of ``tgp_tpu/datasets/multipartite.py``,
a numpy copy): complete multipartite connectivity with per-part labels."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class MultipartiteGraphDataset:
    parts: Sequence[int] = (10, 10, 10)
    feature_dim: int = 8
    seed: int = 0

    samples: List[Tuple] = field(default_factory=list, init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = sum(self.parts)
        labels = np.concatenate(
            [np.full(p, i) for i, p in enumerate(self.parts)])
        edges = []
        for i in range(n):
            for j in range(n):
                if i != j and labels[i] != labels[j]:
                    edges.append((i, j))
        ei = np.array(edges).T
        x = rng.normal(size=(n, self.feature_dim)).astype(np.float32)
        self.samples = [(x, ei.astype(np.int64), labels.astype(np.int32))]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.samples[i]
