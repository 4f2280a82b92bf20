"""NMF pooling level function (port of ``tgp_tpu/precoarsen/nmf.py``;
Bacciu & Di Sotto 2019), without scikit-learn.

``A ≈ WH`` by :func:`non_negative_factorization`, a numpy copy of
scikit-learn's coordinate-descent NMF as the JAX level calls it
(``init="random"``, Frobenius loss, no regularization, cyclic order,
``tol=1e-4``, ``max_iter=5000``); the soft assignment ``S = softmax(Hᵀ)``
padded to a fixed ``k`` for collation; the pooled connectivity
``A' = SᵀAS`` with a zero diagonal, degree-normalized and pruned.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tgp_tpu_torch.precoarsen.common import csr_to_edge_index, to_csr

__all__ = ["nmf_level", "non_negative_factorization"]


def _random_init(X: np.ndarray, k: int, seed: int):
    """scikit-learn's ``init="random"``: ``sqrt(mean(X) / k)`` times the
    absolute value of standard normals from ``RandomState(seed)``, H's
    drawn before W's."""
    n_samples, n_features = X.shape
    avg = np.sqrt(X.mean() / k)
    rng = np.random.RandomState(seed)
    H = avg * rng.standard_normal(size=(k, n_features)).astype(X.dtype,
                                                                copy=False)
    W = avg * rng.standard_normal(size=(n_samples, k)).astype(X.dtype,
                                                               copy=False)
    np.abs(H, out=H)
    np.abs(W, out=W)
    return W, H


def _cd_sweep(X: np.ndarray, W: np.ndarray, Ht: np.ndarray) -> float:
    """One cyclic coordinate-descent pass over the columns of ``W`` (in
    place) for ``X ≈ W Htᵀ``; returns the summed projected-gradient
    violation.  The rows of one column are independent, so each column
    is one vector update; the gradient adds its terms in scikit-learn's
    order (a row's ``cumsum`` over ``[−XHt[i, t], HHt[t, 0]·W[i, 0], …]``
    adds left to right) and the violation is summed row by row,
    component by component, as its Cython loop does."""
    n, k = W.shape
    HHt = np.dot(Ht.T, Ht)
    XHt = np.dot(X, Ht)
    parts = [np.zeros(1)]
    terms = np.empty((n, k + 1))
    for t in range(k):
        terms[:, 0] = -XHt[:, t]
        np.multiply(W, HHt[t], out=terms[:, 1:])
        grad = np.cumsum(terms, axis=1)[:, -1]
        col = W[:, t]
        pg = np.where(col == 0, np.minimum(0.0, grad), grad)
        parts.append(np.abs(pg))
        hess = HHt[t, t]
        if hess != 0:
            W[:, t] = np.maximum(col - grad / hess, 0.0)
    return float(np.cumsum(np.concatenate(parts))[-1])


def non_negative_factorization(X: np.ndarray, n_components: int, *,
                               seed: int = 0, max_iter: int = 5000):
    """``(W [n, k], H [k, m], n_iter)`` with ``X ≈ WH``, ``W, H ≥ 0``:
    scikit-learn's ``non_negative_factorization(X, n_components,
    init="random", random_state=seed, max_iter=max_iter)`` (solver
    ``"cd"``, ``tol=1e-4``).  Each iteration updates W, then H; it stops
    once the violation falls to 1e-4 of the first iteration's."""
    tol = 1e-4
    X = np.asarray(X, np.float64)
    W, H = _random_init(X, n_components, seed)
    W = np.ascontiguousarray(W)
    Ht = np.ascontiguousarray(H.T)
    violation_init = 0.0
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        violation = 0.0
        violation += _cd_sweep(X, W, Ht)
        violation += _cd_sweep(X.T, Ht, W)
        if n_iter == 1:
            violation_init = violation
        if violation_init == 0:
            break
        if violation / violation_init <= tol:
            break
    return W, Ht.T, n_iter


def nmf_level(edge_index, num_nodes, edge_weight=None, *, k: int = 8,
              seed: int = 0, prune_eps: float = 1e-6,
              degree_norm: bool = True) -> dict:
    """One NMF level: a dense ``[n, k]`` assignment and the pooled edges
    (the JAX level's edge cases: ``k ≥ n > 1`` gives the identity,
    ``k = 1`` an all-ones column)."""
    A = to_csr(edge_index, num_nodes, edge_weight)
    Ad = np.clip(A.toarray(), 0.0, None)  # NMF needs a non-negative input
    k_eff = max(1, min(k, num_nodes))
    if num_nodes > 1 and k_eff >= num_nodes:
        S = np.eye(num_nodes)
    elif k_eff == 1:
        S = np.ones((num_nodes, 1))
    else:
        W, H, _ = non_negative_factorization(Ad, k_eff, seed=seed)
        logits = H.T - H.T.max(1, keepdims=True)
        S = np.exp(logits)
        S = S / np.clip(S.sum(1, keepdims=True), 1e-12, None)
    if S.shape[1] < k:  # a fixed k for collation
        S = np.concatenate([S, np.zeros((num_nodes, k - S.shape[1]))], axis=1)

    A_pool = S.T @ A.toarray() @ S
    np.fill_diagonal(A_pool, 0.0)
    if degree_norm:
        d = np.sqrt(np.clip(A_pool.sum(1), 1e-8, None))
        A_pool = A_pool / d[:, None] / d[None, :]
    A_pool[np.abs(A_pool) < prune_eps] = 0.0
    ei_pool, ew_pool = csr_to_edge_index(sp.csr_matrix(A_pool))
    return {
        "kind": "dense",
        "s": S.astype(np.float32),
        "num_clusters": k,
        "edge_index": ei_pool,
        "edge_weight": ew_pool,
        "partial": False,
    }
