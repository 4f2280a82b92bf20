"""NDP, Node Decimation Pooling: level function on the host (port of
``tgp_tpu/precoarsen/ndp.py``; Bianchi et al., TNNLS 2020).

Per graph: the largest eigenvector of ``L_sym`` splits the nodes by sign
(the non-negative side is kept); if the cut fraction ``zᵀLz / (2·vol)`` is
under 0.5, a seeded random ±1 split replaces it; the pooled connectivity
is the Kron reduction ``L' = L⁺⁺ − L⁺⁻ (L⁻⁻)⁻¹ L⁻⁺`` (a 1e-6 diagonal
added where the solve is singular), then ``A' = −L'`` thresholded, with a
zero diagonal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.precoarsen.common import csr_to_edge_index, laplacian_csr

__all__ = ["ndp_level", "kron_reduction"]


def _sign_partition_random(n, rng):
    vec = np.empty(n)
    vec[0] = 1.0
    if n > 1:
        vec[1] = -1.0
    if n > 2:
        vec[2:] = rng.integers(0, 2, n - 2) * 2 - 1
    return vec


def kron_reduction(L: sp.spmatrix, idx_pos, idx_neg,
                   sparse_threshold: float = 1e-2):
    """Kron reduction of ``L`` onto ``idx_pos``: the pooled adjacency as a
    float32 CSR matrix (entries of magnitude ≤ ``sparse_threshold``
    dropped)."""
    if len(idx_pos) <= 1:
        Lnew = sp.csc_matrix(-np.ones((1, 1)))
    elif len(idx_neg) == 0:
        Lnew = L.tocsr()[np.ix_(idx_pos, idx_pos)]
    else:
        L = L.tocsr()
        L_red = L[np.ix_(idx_pos, idx_pos)]
        L_in_out = L[np.ix_(idx_pos, idx_neg)]
        L_out_in = L[np.ix_(idx_neg, idx_pos)].tocsc()
        L_comp = L[np.ix_(idx_neg, idx_neg)].tocsc()
        try:
            sol = spla.spsolve(L_comp, L_out_in)
        except Exception:
            ml_c = sp.csc_matrix(sp.eye(L_comp.shape[0]) * 1e-6)
            sol = spla.spsolve(ml_c + L_comp, L_out_in)
        if sp.issparse(sol):
            Lnew = L_red - L_in_out.dot(sol)
        else:
            Lnew = sp.csr_matrix(L_red.toarray()
                                 - L_in_out.toarray() @ np.atleast_2d(sol))
        # symmetrize when almost symmetric
        asym = np.abs(Lnew - Lnew.T).sum()
        if asym < np.spacing(1.0) * np.abs(Lnew).sum() or asym < 1e-10:
            Lnew = (Lnew + Lnew.T) / 2.0
    A_pool = -sp.csr_matrix(Lnew)
    if sparse_threshold > 0:
        # in place on the sparse data: a dense copy costs O(k²)
        A_pool.data[np.abs(A_pool.data) <= sparse_threshold] = 0.0
        A_pool.eliminate_zeros()
    A_pool.setdiag(0)
    A_pool.eliminate_zeros()
    return A_pool.astype(np.float32)


def ndp_level(edge_index, num_nodes, edge_weight=None, *,
              sparse_threshold: float = 1e-2, seed: int = 0,
              eigensolver: str = "auto", device: DeviceLike = "cuda") -> dict:
    """One NDP level: a partial sparse assignment (the kept nodes, one
    supernode each) and the Kron-reduced pooled edges.

    ``eigensolver``: ``"auto"`` (dense ``eigh`` under 40 nodes, scipy's
    ``eigsh`` from a start vector drawn from ``seed`` above, on the host) or ``"lobpcg"`` (the port's blocked
    LOBPCG, :func:`tgp_tpu_torch.ops.lap.lobpcg`, on ``device``, its start
    block drawn from ``seed``).  ``device`` is read only by ``"lobpcg"``;
    it defaults to ``"cuda"`` and raises without a card."""
    rng = np.random.default_rng(seed)
    L, A = laplacian_csr(edge_index, num_nodes, edge_weight)
    Ls, _ = laplacian_csr(edge_index, num_nodes, edge_weight,
                          normalization="sym")
    dev = resolve_device(device) if eigensolver == "lobpcg" else None

    if num_nodes <= 1:
        vec = np.ones(num_nodes)
    else:
        try:
            if eigensolver == "lobpcg":
                vec = _lobpcg_top(Ls, num_nodes, seed, dev)
            elif num_nodes < 40:
                w, v = np.linalg.eigh(Ls.toarray())
                vec = v[:, -1]
            else:
                # a seeded start: ARPACK's own differs call to call, and
                # with it the eigenvector's sign (the side that is kept)
                v0 = np.random.RandomState(seed).uniform(-1, 1, num_nodes)
                w, v = spla.eigsh(Ls.astype(np.float64), k=1, which="LA",
                                  v0=v0)
                vec = v[:, 0]
        except Exception:
            vec = _sign_partition_random(num_nodes, rng)

        z = np.where(vec >= 0, 1.0, -1.0)
        vol = A.sum()
        cut = (z @ (L @ z)) / (2 * max(vol, 1e-12))
        if cut < 0.5:
            vec = _sign_partition_random(num_nodes, rng)

    idx_pos = np.nonzero(vec >= 0)[0]
    idx_neg = np.nonzero(vec < 0)[0]

    A_pool = kron_reduction(L, idx_pos, idx_neg, sparse_threshold)
    ei_pool, ew_pool = csr_to_edge_index(A_pool)

    k = len(idx_pos)
    cluster_index = np.full(num_nodes, -1, np.int64)
    cluster_index[idx_pos] = np.arange(k)
    return {
        "kind": "sparse",
        "cluster_index": cluster_index,
        "weight": np.where(cluster_index >= 0, 1.0, 0.0).astype(np.float32),
        "num_clusters": k,
        "edge_index": ei_pool,
        "edge_weight": ew_pool,
        "partial": True,
    }


def _lobpcg_top(Ls, num_nodes, seed, device):
    """The largest eigenvector of ``Ls`` by the port's LOBPCG on
    ``device`` (80 iterations, as JAX's), back on the host."""
    import torch

    from tgp_tpu_torch.ops.lap import lobpcg

    coo = Ls.tocoo()

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    gen = torch.Generator(device=device).manual_seed(seed)
    _, v = lobpcg(dev(coo.row, torch.int32), dev(coo.col, torch.int32),
                  dev(coo.data, torch.float32), num_nodes, k=1,
                  num_iters=80, largest=True, generator=gen)
    return v[:, 0].double().cpu().numpy()
