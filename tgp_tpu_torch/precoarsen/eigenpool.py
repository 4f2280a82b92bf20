"""EigenPool level function (port of ``tgp_tpu/precoarsen/eigenpool.py``;
Ma et al., KDD 2019), without scikit-learn.

Spectral clustering (:func:`spectral_clustering`, a numpy and scipy copy
of scikit-learn's ``SpectralClustering(affinity="precomputed",
assign_labels="discretize")`` as the JAX level calls it) gives a hard
partition Ω; the pooling operator Θ ``[N, H·K]`` stacks the first ``H``
eigenvectors of each cluster's subgraph Laplacian (flipped iff the first
entry is negative; columns mode-major, ``h·K + c``); the pooled
connectivity is ``A' = Ωᵀ(A − A_int)Ω``, ``A_int`` the intra-cluster
edges.  :func:`eigenpool_from_labels` is the second half alone: Θ and the
pooled edges from given labels.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import laplacian as csgraph_laplacian
from scipy.sparse.linalg import eigsh

from tgp_tpu_torch.precoarsen.common import csr_to_edge_index, to_csr

__all__ = ["eigenpool_level", "eigenpool_from_labels", "spectral_clustering",
           "discretize"]


def _spectral_embedding(affinity: np.ndarray, n_components: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``_spectral_embedding`` with the ARPACK solver and
    ``drop_first=False``: the ``n_components`` smallest eigenvectors of
    the normalized Laplacian (shift-invert ``eigsh`` at σ = −1e-5 from a
    seeded ``v0``; scipy takes a dense ``eigh`` when ``k ≥ n``), scaled
    by ``D^{-1/2}``, each flipped so its largest |entry| is positive;
    ``[n, n_components]``."""
    n = affinity.shape[0]
    lap, dd = csgraph_laplacian(affinity, normed=True, return_diag=True)
    lap.flat[:: n + 1] = 1
    v0 = rng.uniform(-1, 1, n)
    with warnings.catch_warnings():  # k ≥ n: scipy's note that it takes eigh
        warnings.simplefilter("ignore", RuntimeWarning)
        _, diffusion_map = eigsh(lap, k=n_components, sigma=-1e-5,
                                 which="LM", tol=0, v0=v0)
    embedding = diffusion_map.T[:n_components] / dd
    max_abs_rows = np.argmax(np.abs(embedding), axis=1)
    signs = np.sign(embedding[range(embedding.shape[0]), max_abs_rows])
    embedding *= signs[:, np.newaxis]
    return embedding[:n_components].T


def discretize(vectors: np.ndarray, rng: np.random.RandomState
               ) -> np.ndarray:
    """scikit-learn's ``discretize`` (Yu & Shi 2003): the partition
    closest to the embedding, by alternating a discrete assignment with
    the best rotation (an SVD; at most 20 rounds, 30 restarts from a new
    random row where an SVD fails), from a rotation seeded by a random row
    of ``rng``; labels ``[n]``."""
    max_svd_restarts, n_iter_max = 30, 20
    vectors = np.array(vectors, dtype=np.float64)
    eps = np.finfo(float).eps
    n_samples, n_components = vectors.shape
    norm_ones = np.sqrt(n_samples)
    for i in range(n_components):
        vectors[:, i] = (vectors[:, i] / np.linalg.norm(vectors[:, i])
                         * norm_ones)
        if vectors[0, i] != 0:
            vectors[:, i] = -1 * vectors[:, i] * np.sign(vectors[0, i])
    vectors = vectors / np.sqrt((vectors ** 2).sum(axis=1))[:, np.newaxis]

    svd_restarts = 0
    has_converged = False
    labels = None
    while svd_restarts < max_svd_restarts and not has_converged:
        rotation = np.zeros((n_components, n_components))
        rotation[:, 0] = vectors[rng.randint(n_samples), :].T
        c = np.zeros(n_samples)
        for j in range(1, n_components):
            c += np.abs(np.dot(vectors, rotation[:, j - 1]))
            rotation[:, j] = vectors[c.argmin(), :].T
        last_objective_value = 0.0
        n_iter = 0
        while not has_converged:
            n_iter += 1
            t_discrete = np.dot(vectors, rotation)
            labels = t_discrete.argmax(axis=1)
            vectors_discrete = sp.csc_array(
                (np.ones(len(labels)), (np.arange(0, n_samples), labels)),
                shape=(n_samples, n_components))
            t_svd = vectors_discrete.T @ vectors
            try:
                U, S, Vh = np.linalg.svd(t_svd)
            except np.linalg.LinAlgError:
                svd_restarts += 1
                break
            ncut_value = 2.0 * (n_samples - S.sum())
            if (abs(ncut_value - last_objective_value) < eps
                    or n_iter > n_iter_max):
                has_converged = True
            else:
                last_objective_value = ncut_value
                rotation = np.dot(Vh.T, U.T)
    if not has_converged:
        raise np.linalg.LinAlgError("SVD did not converge")
    return labels


def spectral_clustering(affinity: np.ndarray, n_clusters: int,
                        seed: int = 0) -> np.ndarray:
    """Labels ``[n]`` of scikit-learn's ``SpectralClustering(n_clusters,
    affinity="precomputed", random_state=seed,
    assign_labels="discretize").fit_predict(affinity)`` for a symmetric
    dense affinity: one ``RandomState(seed)`` draws the embedding's
    ``v0``, then the rotation's rows."""
    affinity = np.array(affinity, dtype=np.float64)
    if not np.allclose(affinity, affinity.T, atol=1e-10):
        affinity = 0.5 * (affinity + affinity.T)
    rng = np.random.RandomState(seed)
    maps = _spectral_embedding(affinity, n_clusters, rng)
    return discretize(maps, rng)


def _subgraph_eigvecs(A_sub: np.ndarray, H: int,
                      normalized: bool = True) -> np.ndarray:
    """The first ``H`` eigenvectors of a cluster's Laplacian (normalized by
    default): modes beyond ``n − 1`` repeat the last eigenvector; each
    flipped iff its first entry is negative."""
    n = A_sub.shape[0]
    if normalized:
        d = (A_sub.sum(0).reshape(-1)
             + np.spacing(np.array(0, dtype=A_sub.dtype)))
        dis = 1.0 / np.sqrt(d)
        L = np.eye(n, dtype=A_sub.dtype) - (dis[:, None] * A_sub
                                            * dis[None, :])
    else:
        L = np.diag(A_sub.sum(0).reshape(-1)) - A_sub
    w, v = np.linalg.eigh(L)
    out = np.zeros((n, H))
    for j in range(H):
        col = v[:, min(j, n - 1)]
        if col[0] < 0:
            col = -col
        out[:, j] = col
    return out


def _symmetric_dense(edge_index, num_nodes, edge_weight) -> np.ndarray:
    A = to_csr(edge_index, num_nodes, edge_weight)
    return A.maximum(A.T).toarray()


def eigenpool_from_labels(edge_index, num_nodes, edge_weight=None, *,
                          labels: np.ndarray, k: int = 8,
                          num_modes: int = 3, degree_norm: bool = True,
                          normalized: bool = True) -> dict:
    """The level dict of :func:`eigenpool_level` for a given partition
    ``labels [n]`` (ids in ``[0, k)``): Θ, Ω's pooled edges."""
    Ad = _symmetric_dense(edge_index, num_nodes, edge_weight)
    labels = np.asarray(labels, np.int64)
    k_eff = int(labels.max()) + 1 if labels.size else 1
    H, K = num_modes, k
    theta = np.zeros((num_nodes, H * K), np.float32)
    for c in range(k_eff):
        nodes = np.nonzero(labels == c)[0]
        if nodes.size == 0:
            continue
        if nodes.size == 1:
            # as the reference: a singleton cluster writes its self-loop
            # weight (0 for a simple graph) into every mode column
            theta[nodes[0], c::K] = float(Ad[nodes[0], nodes[0]])
            continue
        vecs = _subgraph_eigvecs(Ad[np.ix_(nodes, nodes)], H,
                                 normalized=normalized)
        for h in range(H):
            theta[nodes, h * K + c] = vecs[:, h]

    omega = np.zeros((num_nodes, K), np.float32)
    omega[np.arange(num_nodes), labels] = 1.0
    inter = Ad * (labels[:, None] != labels[None, :])
    A_pool = omega.T @ inter @ omega
    np.fill_diagonal(A_pool, 0.0)
    if degree_norm:
        d = np.sqrt(np.clip(A_pool.sum(1), 1e-8, None))
        A_pool = A_pool / d[:, None] / d[None, :]
    ei_pool, ew_pool = csr_to_edge_index(sp.csr_matrix(A_pool))
    return {
        "kind": "eigen",
        "cluster_index": labels,
        "theta": theta,
        "num_modes": H,
        "num_clusters": K,
        "edge_index": ei_pool,
        "edge_weight": ew_pool,
        "partial": False,
    }


def eigenpool_level(edge_index, num_nodes, edge_weight=None, *, k: int = 8,
                    num_modes: int = 3, seed: int = 0,
                    degree_norm: bool = True,
                    normalized: bool = True) -> dict:
    """One EigenPool level: spectral-clustering labels (all 0 when
    ``min(k, n) ≤ 1`` or ``n ≤ 2``), then :func:`eigenpool_from_labels`."""
    k_eff = min(k, num_nodes)
    if k_eff <= 1 or num_nodes <= 2:
        labels = np.zeros(num_nodes, np.int64)
    else:
        Ad = _symmetric_dense(edge_index, num_nodes, edge_weight)
        labels = spectral_clustering(Ad + 1e-12, k_eff, seed)
    return eigenpool_from_labels(
        edge_index, num_nodes, edge_weight, labels=labels, k=k,
        num_modes=num_modes, degree_norm=degree_norm, normalized=normalized)
