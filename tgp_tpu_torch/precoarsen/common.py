"""Host-side helpers of the precoarsening level functions (a copy of
``tgp_tpu/precoarsen/common.py``): numpy and scipy only."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["to_csr", "csr_to_edge_index", "coalesce_numpy", "laplacian_csr"]


def to_csr(edge_index, num_nodes, edge_weight=None) -> sp.csr_matrix:
    """``[N, N]`` CSR adjacency (duplicate edges summed; unit weights by
    default)."""
    ei = np.asarray(edge_index)
    w = (np.ones(ei.shape[1]) if edge_weight is None
         else np.asarray(edge_weight, np.float64))
    return sp.csr_matrix((w, (ei[0], ei[1])), shape=(num_nodes, num_nodes))


def csr_to_edge_index(A: sp.spmatrix):
    """``(edge_index [2, E] int64, edge_weight [E] float32)`` of ``A``."""
    A = A.tocoo()
    ei = np.stack([A.row, A.col]).astype(np.int64)
    return ei, A.data.astype(np.float32)


def coalesce_numpy(edge_index, edge_weight, num_nodes):
    """Merge duplicate edges (weights summed), sorted by
    ``(sender, receiver)``."""
    key = edge_index[0].astype(np.int64) * num_nodes + edge_index[1]
    order = np.argsort(key, kind="stable")
    key, w = key[order], edge_weight[order]
    uniq, first = np.unique(key, return_index=True)
    sums = np.add.reduceat(w, first)
    ei = np.stack([uniq // num_nodes, uniq % num_nodes])
    return ei.astype(np.int64), sums


def laplacian_csr(edge_index, num_nodes, edge_weight=None, normalization=None):
    """``(L, A)``: the combinatorial Laplacian of the symmetrized
    adjacency ``A = max(A, Aᵀ)``, or with ``normalization="sym"`` the
    normalized one (0 on an isolated node's diagonal)."""
    A = to_csr(edge_index, num_nodes, edge_weight)
    A = A.maximum(A.T)
    deg = np.asarray(A.sum(1)).ravel()
    if normalization == "sym":
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        Dinv = sp.diags(dinv)
        L = sp.eye(num_nodes) - Dinv @ A @ Dinv
        L = L.tolil()
        for i in np.nonzero(deg == 0)[0]:
            L[i, i] = 0.0
        return L.tocsr(), A
    return sp.diags(deg) - A, A
