"""Laplacian-derived propagation matrices (port of ``tgp_tpu/ops/lap.py``).

* :func:`delta_gcn_matrix`: ``P = I − δ·L_sym``, MaxCut's heterophilic
  propagation, as masked COO with an ``E + N`` budget.
* :func:`laplacian`: the (weighted, optionally sym-normalized) graph
  Laplacian, the same layout.
* :func:`power_iteration_max_eigvec` and :func:`lobpcg`: dominant and
  extreme eigenpairs of a symmetric masked-COO operator (NDP's spectral
  partition), with ``torch.linalg.eigh`` and a ``generator=`` where JAX
  takes a ``seed``.

Every degree and product sums in a fixed order
(:func:`~tgp_tpu_torch.ops.sparse.weighted_degree`,
:func:`~tgp_tpu_torch.ops.sparse.spmm`).
"""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.ops.sparse import spmm, weighted_degree

__all__ = ["delta_gcn_matrix", "laplacian", "power_iteration_max_eigvec",
           "lobpcg"]

Tensor = torch.Tensor


def _dinv(deg: Tensor) -> Tensor:
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                       0.0)


def _with_loops(senders, receivers, off_w, diag_w, edge_mask, node_mask):
    loops = torch.arange(node_mask.shape[0], dtype=senders.dtype,
                         device=senders.device)
    return (torch.cat([senders, loops]), torch.cat([receivers, loops]),
            torch.cat([off_w, diag_w]), torch.cat([edge_mask, node_mask]))


def laplacian(senders, receivers, edge_weight, edge_mask, node_mask,
              num_nodes: int, normalization: Optional[str] = None):
    """``L = D − A`` (or ``I − D^{-1/2} A D^{-1/2}`` with
    ``normalization="sym"``) as masked COO with budget ``E + N``:
    off-diagonal entries ``−A``, the diagonal appended."""
    w = torch.where(edge_mask, edge_weight, 0.0)
    deg = weighted_degree(senders, w, num_nodes)
    if normalization == "sym":
        dinv = _dinv(deg)
        off_w = -w * dinv[senders.long()] * dinv[receivers.long()]
        diag_w = torch.where(node_mask & (deg > 0), 1.0, 0.0)
    else:
        off_w = -w
        diag_w = torch.where(node_mask, deg, 0.0)
    return _with_loops(senders, receivers, off_w, diag_w.to(off_w.dtype),
                       edge_mask, node_mask)


def delta_gcn_diagonal(deg: Tensor, node_mask: Tensor, delta: float
                       ) -> Tensor:
    """``P``'s diagonal: ``1 − δ`` on a valid node with edges, 1 on an
    isolated one (its ``L_sym`` diagonal is 0), 0 on padding."""
    return (torch.where(node_mask & (deg > 0), 1.0 - delta, 0.0)
            + torch.where(node_mask & (deg <= 0), 1.0, 0.0))


def delta_gcn_matrix(senders, receivers, edge_weight, edge_mask, node_mask,
                     num_nodes: int, delta: float = 2.0):
    """``P = I − δ·L_sym = (1−δ)·I + δ·D^{-1/2} A D^{-1/2}`` (masked COO,
    budget ``E + N``; degrees over the senders)."""
    w = torch.where(edge_mask, edge_weight, 0.0)
    deg = weighted_degree(senders, w, num_nodes)
    dinv = _dinv(deg)
    off_w = delta * w * dinv[senders.long()] * dinv[receivers.long()]
    diag_w = delta_gcn_diagonal(deg, node_mask, delta).to(off_w.dtype)
    return _with_loops(senders, receivers, off_w, diag_w, edge_mask,
                       node_mask)


def power_iteration_max_eigvec(senders, receivers, edge_weight,
                               num_nodes: int, num_iters: int = 100,
                               generator: Optional[torch.Generator] = None
                               ) -> Tensor:
    """Dominant eigenvector ``[N]`` of a (symmetric) masked-COO operator
    by power iteration from a normal start drawn from ``generator``."""
    v = torch.randn(num_nodes, 1, generator=generator,
                    device=senders.device)
    for _ in range(num_iters):
        v = spmm(senders, receivers, edge_weight, v, num_nodes)
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    return v[:, 0]


def _orthonormalize(V: Tensor):
    """Symmetric-QR orthonormalization by ``eigh`` of the Gram matrix:
    ``(Q, valid)``, column ``j`` of Q exactly zero where its Gram
    direction is numerically null (relative cut 1e-6), or where the
    normalized column came out with norm ≤ 0.5."""
    w, U = torch.linalg.eigh(V.T @ V)
    valid = w > torch.clamp(1e-6 * w[-1], min=1e-8)
    scale = torch.where(valid, torch.rsqrt(torch.clamp(w, min=1e-12)), 0.0)
    Q = V @ (U * scale[None, :])
    nrm = torch.linalg.vector_norm(Q, dim=0)
    valid = valid & (nrm > 0.5)
    Q = Q * torch.where(valid, 1.0 / torch.clamp(nrm, min=1e-12), 0.0)[None]
    return Q, valid


def lobpcg(senders, receivers, edge_weight, num_nodes: int, k: int = 1, *,
           num_iters: int = 60, largest: bool = True,
           generator: Optional[torch.Generator] = None, tol: float = 0.0):
    """Blocked LOBPCG for the ``k`` extreme eigenpairs of a symmetric
    masked-COO operator: each iteration one SpMM block product over
    ``[X | R | P]`` and a ``3k × 3k`` Rayleigh–Ritz step (``eigh``), for
    ``num_iters`` iterations or until the step after the one whose largest
    residual norm is at most ``tol`` (``tol > 0``; a host read each
    iteration), as JAX's loop stops.  Returns
    ``(eigvals [k], eigvecs [N, k])``, extreme first."""
    N, K = num_nodes, k
    sgn = 1.0 if largest else -1.0

    def matvec(X):
        return spmm(senders, receivers, edge_weight, X, N)

    X, _ = _orthonormalize(torch.randn(N, K, generator=generator,
                                       device=senders.device))
    P = torch.zeros_like(X)
    theta = torch.zeros(K, device=X.device)
    for _ in range(num_iters):
        AX = matvec(X)
        theta = (X * AX).sum(0)
        R = AX - X * theta[None, :]
        res = torch.linalg.vector_norm(R, dim=0).max()
        # explicit deflation (R, P ⟂ X) keeps the Gram near block-diagonal
        R = R - X @ (X.T @ R)
        P_d = P - X @ (X.T @ P)
        S, valid = _orthonormalize(torch.cat([X, R, P_d], 1))
        H = S.T @ matvec(S)
        H = 0.5 * (H + H.T)
        # null columns buried at −∞ so the top-K Ritz picks skip them
        Hs = sgn * H + torch.diag(torch.where(valid, 0.0, -1e30))
        evals, evecs = torch.linalg.eigh(Hs)
        X_new = S @ evecs[:, -K:]
        P = X_new - X @ (X.T @ X_new)
        X = X_new
        theta = sgn * evals[-K:]
        if tol > 0.0 and float(res) <= tol:
            break
    order = torch.argsort(-sgn * theta)
    return theta[order], X[:, order]
