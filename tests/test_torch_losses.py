"""``tgp_tpu_torch/losses.py`` against ``tgp_tpu/losses.py`` on the same
numpy inputs: every name of the JAX module's ``__all__``, its value and
its gradient with respect to the assignment (or the logits, scores or
Beta parameters it takes), on a padded batch and on one that also holds
an empty graph (no valid node).

Values and gradients: 1e-5 of each output's largest |value| (at least 1;
f32 sums in other orders).  Every gradient of the port is finite.  On the
batch with the empty graph the JAX package takes some norms and square
roots at 0 (a graph's ``SᵀS``, its cluster sizes, column norms), where
its gradient is NaN: there the port's is compared only where JAX's is
finite (the port's gradient is 0 at those points, ``losses._safe_sqrt``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp_tpu.losses as JL
import tgp_tpu_torch.losses as TL
import tgp_tpu_torch.ops as t_ops
from tgp_tpu.ops import sparse as j_sparse

torch.set_num_threads(1)
REL = 1e-5
K = 3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, ref, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got, ref, atol=REL * scale, rtol=0,
                               err_msg=what)


def _data(sizes, seed, n_pad=3):
    """Dense ``S [B, Nmax, K]`` (softmax rows, zero on padding), its mask,
    a symmetric weighted adjacency among valid nodes, and the same graphs
    packed flat (``n_pad`` padding rows in the last graph, masked) with
    their COO edges (and two padding edges ``0 → 0`` of weight 0)."""
    rng = np.random.default_rng(seed)
    B, nmax = len(sizes), max(sizes)
    mask = np.zeros((B, nmax), bool)
    S = np.zeros((B, nmax, K), np.float32)
    adj = np.zeros((B, nmax, nmax), np.float32)
    for g, n in enumerate(sizes):
        mask[g, :n] = True
        logits = rng.normal(size=(n, K))
        S[g, :n] = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        a = np.triu((rng.random((n, n)) < 0.4)
                    * (rng.random((n, n)) + 0.2), k=1)
        adj[g, :n, :n] = a + a.T
    node_graph = np.concatenate(
        [np.full(n, g) for g, n in enumerate(sizes)]
        + [np.full(n_pad, B - 1)]).astype(np.int32)
    node_mask = np.concatenate([np.ones(sum(sizes), bool),
                                np.zeros(n_pad, bool)])
    S_flat = np.concatenate([S[g, :n] for g, n in enumerate(sizes)]
                            + [np.zeros((n_pad, K), np.float32)])
    offs = np.concatenate([[0], np.cumsum(sizes)])
    s, r, w = [], [], []
    for g, n in enumerate(sizes):
        gs, gr = np.nonzero(adj[g, :n, :n])
        s.append(gs + offs[g])
        r.append(gr + offs[g])
        w.append(adj[g, gs, gr])
    s = np.concatenate(s + [[0, 0]]).astype(np.int32)
    r = np.concatenate(r + [[0, 0]]).astype(np.int32)
    w = np.concatenate(w + [[0.0, 0.0]]).astype(np.float32)
    n_nodes = S_flat.shape[0]
    return dict(
        S=S, mask=mask, adj=adj, S_flat=S_flat, ng=node_graph,
        nm=node_mask, s=s, r=r, w=w, B=B,
        logits=rng.normal(size=(B, nmax, nmax)).astype(np.float32),
        kl=rng.random((B, nmax)).astype(np.float32),
        kl_flat=rng.random(n_nodes).astype(np.float32),
        scores=np.tanh(rng.normal(size=(n_nodes, 1))).astype(np.float32),
        motif_s=rng.normal(size=(n_nodes, K)).astype(np.float32),
        motif_deg=(rng.random(n_nodes) + 0.5).astype(np.float32),
        edge_logits=rng.normal(size=s.shape[0]).astype(np.float32),
        edge_y=(rng.random(s.shape[0]) < 0.5).astype(np.float32),
        edges_graph=node_graph[s],
        sample_mask=rng.random(s.shape[0]) < 0.8,
        beta=(rng.random((4, K)) * 2 + 0.3).astype(np.float32),
        sums=(rng.random((6, B)) + 0.1).astype(np.float32),
        ca=rng.normal(size=(B, K)).astype(np.float32),
        prior_k=rng.normal(size=(K, K)).astype(np.float32),
        norm_const=np.array([3.0, 5.0], np.float32))


DATA = {"padded": _data([5, 7, 4], 0), "empty": _data([5, 7, 0, 4], 1)}


class _Ns:
    """One package's view of the data: its loss module, arrays, einsum."""

    def __init__(self, L, arr, ein, data):
        self.L, self.ein = L, ein
        self.d = {k: (arr(v) if isinstance(v, np.ndarray) else v)
                  for k, v in data.items()}

    def __getattr__(self, k):
        return self.d[k]


def _pool(n, S):
    return n.ein("bnk,bnm,bmj->bkj", S, n.adj, S)


def _coo(n):
    return n.s, n.r, n.w


# name → (differentiable input, loss of it); every case is one call
CASES = {
    "mincut_loss": ("S", lambda n, S: n.L.mincut_loss(n.adj, S,
                                                      _pool(n, S))),
    "mincut_loss_sum": ("S", lambda n, S: n.L.mincut_loss(
        n.adj, S, _pool(n, S), batch_reduction="sum")),
    "sparse_mincut_loss": ("S_flat", lambda n, S: n.L.sparse_mincut_loss(
        *_coo(n), S, n.ng, n.B, n.nm)),
    "sparse_ho_mincut_loss": ("S_flat",
                              lambda n, S: n.L.sparse_ho_mincut_loss(
                                  *_coo(n), S, n.ng, n.B, n.nm)),
    "mincut_from_sums": ("sums", lambda n, x: n.L.mincut_from_sums(
        x[0], x[1]).sum()),
    "ho_mincut_from_motif": ("S_flat", lambda n, S: n.L.ho_mincut_from_motif(
        S, n.motif_s, n.motif_deg, n.ng, n.B, n.nm)),
    "link_pred_from_sums": ("sums", lambda n, x: n.L.link_pred_from_sums(
        x[0].sum() + 4, x[1].sum(), x[2].sum(), x[3].sum())),
    "spectral_from_sums": ("ca", lambda n, ca: n.L.spectral_from_sums(
        n.sums[0], ca, n.sums[1]).sum()),
    "totvar_from_sums": ("sums", lambda n, x: n.L.totvar_from_sums(
        x[0], x[1] * 3).sum()),
    "orthogonality_loss": ("S", lambda n, S: n.L.orthogonality_loss(S)),
    "unbatched_orthogonality_loss": (
        "S_flat", lambda n, S: n.L.unbatched_orthogonality_loss(
            S, n.ng, n.B, n.nm)),
    "hosc_orthogonality_loss": (
        "S", lambda n, S: n.L.hosc_orthogonality_loss(S, mask=n.mask)),
    "hosc_orthogonality_loss_unmasked": (
        "S", lambda n, S: n.L.hosc_orthogonality_loss(S)),
    "unbatched_hosc_orthogonality_loss": (
        "S_flat", lambda n, S: n.L.unbatched_hosc_orthogonality_loss(
            S, n.ng, n.B, n.nm)),
    "link_pred_loss": ("S", lambda n, S: n.L.link_pred_loss(
        S, n.adj, mask=n.mask)),
    "link_pred_loss_unmasked": ("S", lambda n, S: n.L.link_pred_loss(
        S, n.adj, normalize_loss=True)),
    "sparse_link_pred_loss": ("S_flat", lambda n, S: n.L.sparse_link_pred_loss(
        S, *_coo(n), n.ng, n.B, n.nm)),
    "entropy_loss": ("S", lambda n, S: n.L.entropy_loss(S, mask=n.mask)),
    "unbatched_entropy_loss": ("S_flat", lambda n, S: n.L.unbatched_entropy_loss(
        S, node_mask=n.nm)),
    "totvar_loss": ("S", lambda n, S: n.L.totvar_loss(S, n.adj)),
    "sparse_totvar_loss": ("S_flat", lambda n, S: n.L.sparse_totvar_loss(
        *_coo(n), S, n.ng, n.B)),
    "asym_norm_loss": ("S", lambda n, S: n.L.asym_norm_loss(S, K,
                                                            mask=n.mask)),
    "asym_norm_loss_unmasked": ("S", lambda n, S: n.L.asym_norm_loss(S, K)),
    "unbatched_asym_norm_loss": (
        "S_flat", lambda n, S: n.L.unbatched_asym_norm_loss(
            S, K, n.ng, n.B, n.nm)),
    "just_balance_loss": ("S", lambda n, S: n.L.just_balance_loss(
        S, mask=n.mask)),
    "just_balance_loss_unmasked": ("S", lambda n, S: n.L.just_balance_loss(
        S, batch_reduction="sum")),
    "unbatched_just_balance_loss": (
        "S_flat", lambda n, S: n.L.unbatched_just_balance_loss(
            S, n.ng, n.B, n.nm)),
    "spectral_loss": ("S", lambda n, S: n.L.spectral_loss(
        n.adj, S, _pool(n, S), mask=n.mask)),
    "sparse_spectral_loss": ("S_flat", lambda n, S: n.L.sparse_spectral_loss(
        *_coo(n), S, n.ng, n.B, n.nm)),
    "cluster_loss": ("S", lambda n, S: n.L.cluster_loss(S, mask=n.mask)),
    "unbatched_cluster_loss": ("S_flat", lambda n, S: n.L.unbatched_cluster_loss(
        S, n.ng, n.B, n.nm)),
    "weighted_bce_reconstruction_loss": (
        "logits", lambda n, x: n.L.weighted_bce_reconstruction_loss(
            x, (n.adj != 0) * 1.0, mask=n.mask)),
    "weighted_bce_reconstruction_loss_plain": (
        "logits", lambda n, x: n.L.weighted_bce_reconstruction_loss(
            x, (n.adj != 0) * 1.0, balance_links=False,
            normalizing_const=n.norm_const[0])),
    "sparse_bce_reconstruction_loss": (
        "edge_logits", lambda n, x: n.L.sparse_bce_reconstruction_loss(
            x, n.edge_y, n.edges_graph, n.B, n.sample_mask)[0]),
    "sparse_bce_reconstruction_loss_flat": (
        "edge_logits", lambda n, x: n.L.sparse_bce_reconstruction_loss(
            x, n.edge_y, sample_mask=n.sample_mask)[0]),
    "kl_loss": ("kl", lambda n, x: n.L.kl_loss(x, mask=n.mask)),
    "kl_loss_segments": ("kl_flat", lambda n, x: n.L.kl_loss(
        x, node_graph=n.ng, num_graphs=n.B, node_mask=n.nm,
        normalizing_const=n.norm_const[1])),
    "beta_kl_divergence": ("beta", lambda n, x: n.L.beta_kl_divergence(
        x[0], x[1], x[2], x[3]).sum()),
    "cluster_connectivity_prior_loss": (
        "prior_k", lambda n, x: n.L.cluster_connectivity_prior_loss(
            x, x * 0.5 + 0.1, 2.0, normalizing_const=n.norm_const)),
    "maxcut_loss": ("scores", lambda n, z: n.L.maxcut_loss(
        z, *_coo(n), n.ng, n.B)),
}


def _run_jax(name, kind):
    key, fn = CASES[name]
    n = _Ns(JL, jnp.asarray, jnp.einsum, DATA[kind])
    x = n.d[key]
    return jax.value_and_grad(lambda v: fn(n, v))(x)


def _run_torch(name, kind):
    key, fn = CASES[name]
    n = _Ns(TL, torch.tensor, torch.einsum, DATA[kind])
    x = n.d[key].clone().requires_grad_(True)
    val = fn(n, x)
    val.backward()
    return val, x.grad


@pytest.mark.parametrize("kind", ["padded", "empty"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, kind):
    jv, jg = _run_jax(name, kind)
    tv, tg = _run_torch(name, kind)
    _close(tv, jv, what=f"{name} value")
    assert tg is not None and torch.isfinite(tg).all(), name
    jg = _np(jg)
    finite = np.isfinite(jg)
    if kind == "padded":
        assert finite.all(), name
    _close(_np(tg)[finite], jg[finite], what=f"{name} gradient")


def test_every_jax_loss_is_ported_and_tested():
    """The port's ``__all__`` is JAX's, and each name has a case above."""
    assert TL.__all__ == JL.__all__ and len(TL.__all__) == 32
    for name in TL.__all__:
        assert any(c == name or c.startswith(name + "_") for c in CASES), name


def test_empty_graph_losses_stay_finite_where_jax_is_nan():
    """The reason for ``_safe_sqrt``: on the batch with an empty graph
    JAX's gradient of the orthogonality loss is NaN, the port's finite
    and zero on that graph's rows."""
    _, jg = _run_jax("orthogonality_loss", "empty")
    _, tg = _run_torch("orthogonality_loss", "empty")
    assert not np.isfinite(_np(jg)).all()
    assert torch.isfinite(tg).all() and not tg[2].any()


def test_rank3_ops_and_sddmm_match_jax():
    d = DATA["padded"]
    _close(t_ops.rank3_trace(torch.tensor(d["adj"])),
           j_sparse.rank3_trace(jnp.asarray(d["adj"])))
    _close(t_ops.rank3_diag(torch.tensor(d["kl"])),
           j_sparse.rank3_diag(jnp.asarray(d["kl"])))
    a = d["S_flat"]
    _close(t_ops.sddmm(torch.tensor(d["s"]), torch.tensor(d["r"]),
                       torch.tensor(a), torch.tensor(a[::-1].copy())),
           j_sparse.sddmm(jnp.asarray(d["s"]), jnp.asarray(d["r"]),
                          jnp.asarray(a), jnp.asarray(a[::-1].copy())))


@pytest.mark.parametrize("batched", [True, False])
def test_asym_norm_quantile_takes_jax_element_on_ties(batched):
    """Tied assignment values: the quantile's gradient reaches the same
    element in both packages (the batched loss sorts ascending and
    reverses, the unbatched twin ranks by index)."""
    d = dict(DATA["padded"])
    S = d["S"].copy()
    S[:, :, 0] = np.round(S[:, :, 0], 1)  # many ties in column 0
    S_flat = d["S_flat"].copy()
    S_flat[:, 0] = np.round(S_flat[:, 0], 1)
    key = "S" if batched else "S_flat"
    d[key] = S if batched else S_flat
    name = "asym_norm_loss" if batched else "unbatched_asym_norm_loss"
    fn = CASES[name][1]
    jn = _Ns(JL, jnp.asarray, jnp.einsum, d)
    jg = jax.grad(lambda v: fn(jn, v))(jn.d[key])
    tn = _Ns(TL, torch.tensor, torch.einsum, d)
    x = tn.d[key].clone().requires_grad_(True)
    fn(tn, x).backward()
    _close(x.grad, jg, what=name)
