"""Contextual stochastic block model dataset (port of
``tgp_tpu/datasets/csbm.py``, a numpy copy: the same graphs, features and
labels for a seed): SBM connectivity with a retry loop until the graph is
connected, plus Gaussian (or GMM) community-conditioned features."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph


@dataclass
class CSBMDataset:
    """Generates ``num_graphs`` CSBM graphs; each sample is
    ``(x, edge_index, community_labels)``."""

    num_graphs: int = 1
    num_nodes: int = 100
    num_communities: int = 4
    p_in: float = 0.3
    p_out: float = 0.02
    feature_dim: int = 16
    mu: float = 1.0
    gmm_components: int = 1
    require_connected: bool = True
    max_retries: int = 20
    seed: int = 0

    samples: List[Tuple] = field(default_factory=list, init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_graphs):
            self.samples.append(self._one(rng))

    def _one(self, rng):
        n, C = self.num_nodes, self.num_communities
        for _ in range(self.max_retries):
            comm = rng.integers(0, C, n)
            probs = np.where(comm[:, None] == comm[None, :], self.p_in,
                             self.p_out)
            upper = np.triu(rng.random((n, n)) < probs, k=1)
            adj = upper | upper.T
            if not self.require_connected:
                break
            ncomp = csgraph.connected_components(
                sp.csr_matrix(adj), directed=False, return_labels=False)
            if ncomp == 1:
                break
        else:
            # returning the last disconnected draw would violate
            # require_connected invisibly
            raise RuntimeError(
                f"CSBM stayed disconnected after {self.max_retries} draws "
                f"(n={n}, p_in={self.p_in}, p_out={self.p_out}); raise the "
                "edge probabilities / max_retries or pass "
                "require_connected=False")
        s, r = np.nonzero(adj)
        ei = np.stack([s, r]) if s.size else np.array([[0], [0]])
        # community-conditioned GMM features
        means = rng.normal(size=(C, self.gmm_components, self.feature_dim))
        comp = rng.integers(0, self.gmm_components, n)
        x = (self.mu * means[comm, comp]
             + rng.normal(size=(n, self.feature_dim))).astype(np.float32)
        return x, ei.astype(np.int64), comm.astype(np.int32)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]
