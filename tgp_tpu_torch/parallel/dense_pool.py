"""Sharded dense-pooler family (port of ``tgp_tpu/parallel/dense_pool.py``):
node-sharded ``SᵀX`` / ``SᵀAS`` for the MLPSelect/DPSelect-driven
cluster poolers (MinCut, DiffPool, DMoN, HOSC, JustBalance,
AsymCheegerCut, BNPool), driven by the pooler's own modules.

One large graph, its nodes row-sharded over the ranks of a process group
(a ``DeviceMesh`` axis), its edges partitioned by the receiver's owner
(:func:`prepare_sharded_dense_graph`).  Every step of the unbatched dense
forward decomposes over the shards into shared primitives, each needing
one collective:

  select    s_loc = selector(x_loc)                  row-wise, no collective
  s_full    all_gather of ``[N, K]``
  reduce    SᵀX  = Σ_ranks s_locᵀ x_loc              psum ``[K, F]``
  connect   SᵀAS = Σ_ranks s_locᵀ (A_d S)            K1, then psum ``[K, K]``
  degrees   d    = Σ_{local edges} w by sender        K4, then psum ``[N]``
  edge sums Σ(w − ss)², Σ ss², Σ w|s_i − s_j|₁, …     psum of scalars
  motif     A³·[S | 1] by 3 × (K1 onto senders + psum)  (HOSC only)

Per-pooler loss hooks combine them with the port's :mod:`~tgp_tpu_torch.
losses` (the ``unbatched_*`` twins and the ``*_from_sums`` combinators),
as the single-device unbatched forward does.

``shard_map`` becomes SPMD over the ranks: every rank calls the returned
function with its shard (:func:`device_put_sharded_dense`).  Collectives
are :mod:`~tgp_tpu_torch.parallel._collectives`' (rank-order sums, a
replicated loss seeded ``1/D``); every float sum adds in a fixed order:
edge sums on K1 over a :class:`~tgp_tpu_torch.parallel.spmm.CsrLayout`
made once per partition, node sums on K4 after a stable sort, row gathers
by :func:`~tgp_tpu_torch.ops.segment.gather_rows`.  ``SᵀX`` and ``SᵀAS``'s
last product are ``torch.matmul`` (JAX's ``einsum``, outside Pallas).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tgp_tpu_torch import losses as L
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import gather_rows, segment_sum
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.parallel._collectives import (all_gather_rows,
                                                 group_rank, group_size,
                                                 local_shard, pmean, psum)
from tgp_tpu_torch.parallel.spmm import (CsrLayout, _LayoutCache,
                                         partition_edges)

__all__ = [
    "prepare_sharded_dense_graph",
    "prepare_sharded_negatives",
    "make_sharded_dense_pool_step",
    "supported_sharded_poolers",
    "device_put_sharded_dense",
]

Tensor = torch.Tensor


def supported_sharded_poolers() -> Tuple[str, ...]:
    """Pooler aliases with a sharded loss decomposition: the 7-pooler
    dense cluster family."""
    return ("mincut", "diff", "dmon", "hosc", "jb", "acc", "bnpool")


def prepare_sharded_dense_graph(x, senders, receivers, edge_weight,
                                num_nodes: int, n_devices: int, *,
                                device: DeviceLike = "cuda"):
    """Host-side prep: pad the node axis to a multiple of ``n_devices`` and
    partition the edges by receiver owner (:func:`~tgp_tpu_torch.parallel.
    spmm.partition_edges`).  Returns ``(x_pad [n_pad, F], mask [n_pad],
    S, R, W [D, E_loc], n_pad, rows_per)`` on ``device``, ``S`` in global
    and ``R`` in local row coordinates (the same arrays as JAX's)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    w = (np.ones(len(np.asarray(senders)), np.float32)
         if edge_weight is None else np.asarray(edge_weight, np.float32))
    S, R, W, n_pad, rows_per = partition_edges(
        senders, receivers, w, num_nodes, n_devices, device=dev)
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:num_nodes] = x
    mask = np.zeros(n_pad, bool)
    mask[:num_nodes] = True
    return (torch.as_tensor(x_pad, device=dev),
            torch.as_tensor(mask, device=dev), S, R, W, n_pad, rows_per)


def prepare_sharded_negatives(seed: int, senders, receivers, num_nodes: int,
                              n_devices: int, num_samples: int | None = None,
                              *, device: DeviceLike = "cuda"):
    """Host-side negative-edge sampling for the sharded BNPool quality
    loss: ``num_samples`` (default one per positive edge) random non-edges
    from ``numpy.random.default_rng(seed)``, split round-robin across the
    ranks — JAX's draws and arrays.

    Returns ``(NS, NR, NM) [D, M]`` (both endpoints in global coordinates,
    a validity mask) and ``flat = (senders, receivers, mask)`` of the
    valid draws, to hand the single-device ``BNPool(..., negatives=...)``
    for the same function; tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    n_neg = int(num_samples) if num_samples is not None else len(senders)
    edge_keys = np.unique(senders.astype(np.int64) * num_nodes
                          + receivers.astype(np.int64))
    ns = np.zeros(n_neg, np.int64)
    nr = np.zeros(n_neg, np.int64)
    nm = np.zeros(n_neg, bool)
    got = 0
    for _ in range(20):  # bounded rejection sampling
        if got >= n_neg:
            break
        cand_s = rng.integers(0, num_nodes, n_neg - got)
        cand_r = rng.integers(0, num_nodes, n_neg - got)
        ok = (cand_s != cand_r) & ~np.isin(cand_s * num_nodes + cand_r,
                                           edge_keys)
        k = int(ok.sum())
        ns[got:got + k] = cand_s[ok]
        nr[got:got + k] = cand_r[ok]
        nm[got:got + k] = True
        got += k
    # round-robin: draw i goes to rank i mod D, slot i div D
    m_per = -(-max(n_neg, 1) // n_devices)

    def split(a, dtype):
        out = np.zeros(m_per * n_devices, dtype)
        out[:n_neg] = a
        return torch.as_tensor(
            np.ascontiguousarray(out.reshape(m_per, n_devices).T), device=dev)

    flat = tuple(torch.as_tensor(a[:got], device=dev) for a in (ns, nr, nm))
    return (split(ns, np.int32), split(nr, np.int32), split(nm, bool), flat)


def device_put_sharded_dense(mesh, x_pad, mask, S, R, W, axis: str = "n"):
    """This rank's shards of the prepared arrays on the mesh's device:
    ``(x_loc [rows_per, F], m_loc [rows_per], S_d, R_d, W_d [E_loc])``
    (JAX places the whole arrays with a ``P(axis)`` sharding)."""
    group = mesh.get_group(axis)
    d = group_rank(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return (local_shard(torch.as_tensor(x_pad), group).to(dev),
            local_shard(torch.as_tensor(mask), group).to(dev),
            S[d].to(dev), R[d].to(dev), W[d].to(dev))


def _local_view(x_loc: Tensor, m_loc: Tensor, rows_per: int,
                row0: int) -> GraphBatch:
    """A flat single-graph :class:`GraphBatch` over one node shard, enough
    for the row-wise unbatched selectors (``x``, ``node_mask``,
    ``node_pos``).  ``node_pos`` holds global node indices, so per-node
    draws (``DPSelect(per_node_keys=True)``) do not depend on the
    sharding."""
    dev = x_loc.device
    zi = torch.zeros(1, dtype=torch.int32, device=dev)
    return GraphBatch(
        x=x_loc, senders=zi, receivers=zi,
        edge_weight=torch.zeros(1, dtype=x_loc.dtype, device=dev),
        node_graph=torch.zeros(rows_per, dtype=torch.int32, device=dev),
        node_pos=row0 + torch.arange(rows_per, dtype=torch.int32,
                                     device=dev),
        node_mask=m_loc,
        edge_mask=torch.zeros(1, dtype=torch.bool, device=dev),
        num_graphs=1, max_nodes=rows_per)


@dataclass
class _Primitives:
    """The shared sharded primitives every loss hook reads: psummed or
    replicated by a gather."""

    s_full: Tensor      # [n_pad, K] gathered assignments (0 on padding)
    mask_full: Tensor   # [n_pad] bool validity
    node_graph: Tensor  # [n_pad] zeros: the single-graph view
    d_full: Tensor      # [n_pad] sender degrees Σ_e w_e (psummed)
    x_pool: Tensor      # [K, F] = SᵀX (psummed)
    adj_raw: Tensor     # [K, K] = SᵀAS before post-processing (psummed)
    n_valid: Tensor     # scalar Σ mask (psummed)
    s_d: Tensor         # [E_loc] local-edge senders, global
    r_glob: Tensor      # [E_loc] local-edge receivers, global
    w_d: Tensor         # [E_loc] local-edge weights (0 = padding)
    layout: CsrLayout   # (s_d → r_loc) into this rank's rows
    layout_t: CsrLayout  # (r_glob → s_d) into the n_pad senders
    group: object

    def psum(self, v: Tensor) -> Tensor:
        return psum(v, self.group)

    def spmm_full(self, Z: Tensor) -> Tensor:
        """Full ``A·Z`` (``[n_pad, C]`` replicated): each owned row's sum
        on K1 (edges are partitioned by receiver owner, so a row's sum is
        complete on its owner), then an all_gather."""
        return all_gather_rows(self.layout.spmm(Z, self.w_d), self.group)

    def spmm_t_full(self, Z: Tensor) -> Tensor:
        """``out[i] = Σ_{e: send(e)=i} w_e · Z[recv(e)]``, the operator of
        the sparse loss twins: each rank's edges summed onto the global
        senders on K1, then psummed (senders are not owner-local)."""
        return self.psum(self.layout_t.spmm(Z, self.w_d))

    def pair_rows(self, a: Tensor, b: Tensor):
        """``s_full`` rows at ``a`` and ``b`` (gradients in a fixed
        order)."""
        n = self.s_full.shape[0]
        return (gather_rows(self.s_full, a, n),
                gather_rows(self.s_full, b, n))


# ---------------------------------------------------------------------------
# Per-pooler loss hooks: the pooler's own ``compute_sparse_loss`` dict on
# the full graph, from the shared primitives and losses.py.
# ---------------------------------------------------------------------------


def _mincut_cut_sums(pr: _Primitives):
    num = torch.trace(pr.adj_raw)
    den = torch.sum(pr.d_full * torch.sum(pr.s_full * pr.s_full, -1))
    return num, den


def _hook_mincut(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    cut = L.mincut_from_sums(*_mincut_cut_sums(pr))
    ortho = L.unbatched_orthogonality_loss(pr.s_full, pr.node_graph, 1,
                                           pr.mask_full)
    return {"cut_loss": pooler.cut_loss_coeff * cut,
            "ortho_loss": pooler.ortho_loss_coeff * ortho}


def _hook_diff(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    real = (pr.w_d != 0).to(pr.w_d.dtype)
    s_i, s_j = pr.pair_rows(pr.s_d, pr.r_glob)
    ss_e = torch.sum(s_i * s_j, -1)
    sum_res = pr.psum(torch.sum((pr.w_d - ss_e) ** 2 * real))
    sum_ss = pr.psum(torch.sum(ss_e ** 2 * real))
    sts = torch.matmul(pr.s_full.T, pr.s_full)
    link = L.link_pred_from_sums(sum_res, sum_ss, torch.sum(sts * sts),
                                 pr.n_valid * pr.n_valid,
                                 normalize_loss=pooler.normalize_loss)
    ent = L.unbatched_entropy_loss(pr.s_full, node_mask=pr.mask_full)
    return {"link_loss": pooler.link_loss_coeff * link,
            "entropy_loss": pooler.ent_loss_coeff * ent}


def _hook_dmon(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    tr_ast = torch.trace(pr.adj_raw)
    m = torch.sum(pr.d_full) / 2
    ca = torch.matmul(pr.d_full, pr.s_full)
    args = (pr.node_graph, 1, pr.mask_full)
    return {
        "spectral_loss": pooler.spectral_loss_coeff
        * L.spectral_from_sums(tr_ast, ca, m),
        "cluster_loss": pooler.cluster_loss_coeff
        * L.unbatched_cluster_loss(pr.s_full, *args),
        "ortho_loss": pooler.ortho_loss_coeff
        * L.unbatched_orthogonality_loss(pr.s_full, *args),
    }


def _hook_hosc(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    args = (pr.node_graph, 1, pr.mask_full)
    zero = pr.s_full.new_zeros(())
    cut = ho_cut = zero
    if pooler.alpha < 1:
        cut = L.mincut_from_sums(*_mincut_cut_sums(pr)) / pooler.k
    if pooler.alpha > 0:
        # the motif operator A³ on [S | 1]: one chain of three sums onto
        # the senders (the sparse loss twin's A(A(AS)))
        ext = torch.cat([pr.s_full, torch.ones_like(pr.s_full[:, :1])], -1)
        Z = pr.spmm_t_full(pr.spmm_t_full(pr.spmm_t_full(ext)))
        ho_cut = L.ho_mincut_from_motif(pr.s_full, Z[:, :-1], Z[:, -1],
                                        *args) / pooler.k
    hosc = (1 - pooler.alpha) * cut + pooler.alpha * ho_cut
    if pooler.mu == 0:
        ortho = zero
    elif pooler.hosc_ortho:
        ortho = L.unbatched_hosc_orthogonality_loss(pr.s_full, *args)
    else:
        ortho = L.unbatched_orthogonality_loss(pr.s_full, *args)
    return {"hosc_loss": hosc, "ortho_loss": pooler.mu * ortho}


def _hook_jb(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    return {"balance_loss": pooler.loss_coeff * L.unbatched_just_balance_loss(
        pr.s_full, pr.node_graph, 1, pr.mask_full,
        normalize_loss=pooler.normalize_loss)}


def _hook_acc(pooler, pr: _Primitives) -> Dict[str, Tensor]:
    s_i, s_j = pr.pair_rows(pr.s_d, pr.r_glob)
    l1 = torch.sum(torch.abs(s_i - s_j), -1)
    wl1 = pr.psum(torch.sum(pr.w_d * l1))
    n_edges = pr.psum(torch.sum((pr.w_d != 0).to(pr.s_full.dtype)))
    return {
        "total_variation_loss": pooler.totvar_coeff
        * L.totvar_from_sums(wl1, n_edges),
        "balance_loss": pooler.balance_coeff * L.unbatched_asym_norm_loss(
            pr.s_full, pooler.k, pr.node_graph, 1, pr.mask_full),
    }


def _resolve_hook(pooler):
    """``(kind, hook)`` of a pooler instance (imported here: this module
    is a leaf of the pooler layer)."""
    from tgp_tpu_torch.poolers.asym_cheeger_cut import AsymCheegerCutPooling
    from tgp_tpu_torch.poolers.bnpool import BNPool
    from tgp_tpu_torch.poolers.diffpool import DiffPool
    from tgp_tpu_torch.poolers.dmon import DMoNPooling
    from tgp_tpu_torch.poolers.hosc import HOSCPooling
    from tgp_tpu_torch.poolers.just_balance import JustBalancePooling
    from tgp_tpu_torch.poolers.mincut import MinCutPooling

    table = [
        (MinCutPooling, "mincut", _hook_mincut),
        (DiffPool, "diff", _hook_diff),
        (DMoNPooling, "dmon", _hook_dmon),
        (HOSCPooling, "hosc", _hook_hosc),
        (JustBalancePooling, "jb", _hook_jb),
        (AsymCheegerCutPooling, "acc", _hook_acc),
        (BNPool, "bnpool", None),  # its own body (draws and negatives)
    ]
    for cls, kind, hook in table:
        if isinstance(pooler, cls):
            return kind, hook
    raise NotImplementedError(
        f"sharded dense pooling implemented for "
        f"{supported_sharded_poolers()}, got {type(pooler).__name__}")


def _rank_seed(seed: int, rank: int) -> int:
    """A seed per rank from the step's seed (JAX's ``fold_in(rng,
    axis_index)``)."""
    return (int(seed) * 1_000_003 + rank + 1) % (2 ** 63)


@contextlib.contextmanager
def _selector_mode(pooler, training: bool, seed: Optional[int], rank: int,
                   device: torch.device):
    """The selector's MLP in ``training`` mode (dropout on) for one call,
    its dropout drawn from a generator seeded per rank when ``seed`` is
    given; restored after."""
    mlp = pooler.selector.mlp
    was, gen = mlp.training, mlp.dropout_generator
    mlp.train(training)
    if training and seed is not None:
        mlp.dropout_generator = torch.Generator(device).manual_seed(
            _rank_seed(seed, rank))
    try:
        yield
    finally:
        mlp.train(was)
        mlp.dropout_generator = gen


def make_sharded_dense_pool_step(pooler, mesh, rows_per: int,
                                 axis: str = "n", *,
                                 deterministic: bool = True):
    """The sharded dense-pooling forward for ``pooler`` (an unbatched
    ``batched=False`` instance of an alias in
    :func:`supported_sharded_poolers`) on ``mesh``'s ``axis``.

    Returns ``fn(x_loc, m_loc, S_d, R_d, W_d) → (x_pool [K, F], adj_pool
    [K, K] post-processed, loss dict)``, the inputs this rank's shards
    (:func:`device_put_sharded_dense`) and the outputs replicated.  The
    pooler holds its own parameters (JAX's ``fn`` takes ``params``
    first); their gradients are this rank's part, to be summed over the
    ranks (``psum_grads_``) after a replicated loss is seeded ``1/D``
    (``backward_replicated``).

    ``deterministic=False`` turns the selector's dropout on: ``fn`` then
    takes a leading integer ``seed``, and each rank draws its dropout from
    a generator seeded by ``(seed, rank)``.

    **BNPool** (built with ``per_node_keys=True``, asserted): ``fn(seed,
    x_loc, m_loc, S_d, R_d, W_d, NS_d, NR_d, NM_d)`` with the negatives
    of :func:`prepare_sharded_negatives`; ``seed`` is the base seed of the
    per-node draws, the same on every rank (JAX's sample key is not
    folded with the rank), or None to draw it from the pooler's sample
    generator; with ``deterministic=False`` it seeds the dropout too.
    """
    kind, hook = _resolve_hook(pooler)
    assert not pooler.batched, (
        "pass an unbatched pooler (batched=False / '<alias>_u'): the sharded "
        "path is the distributed twin of the unbatched dense forward")
    if kind == "bnpool":
        assert getattr(pooler.selector, "per_node_keys", False), (
            "sharded BNPool needs per_node_keys=True so the Beta draws are "
            "keyed by global node index (sharding-invariant draws)")

    group = mesh.get_group(axis)
    n_pad = rows_per * group_size(group)
    row0 = group_rank(group) * rows_per
    # (s_d → r_loc) into this rank's rows; (r_glob → s_d) onto senders
    layouts = _LayoutCache(lambda s, r: (
        CsrLayout(s, r, rows_per, n_pad),
        CsrLayout(r.to(torch.int64) + row0, s, n_pad, n_pad)))

    def primitives(s_loc, x_loc, m_loc, s_d, r_d, w_d):
        dev = s_loc.device
        layout, layout_t = layouts(s_d, r_d)
        s_full = all_gather_rows(s_loc, group)  # [n_pad, K]
        mask_full = all_gather_rows(m_loc.to(torch.uint8), group).bool()
        x_pool = psum(torch.matmul(s_loc.T, x_loc), group)
        # z_r = Σ_{e: recv=r local} w_e s[send_e]; Σ_r s_r ⊗ z_r = (SᵀAS)ᵀ
        z_loc = layout.spmm(s_full, w_d)
        adj_raw = psum(torch.matmul(s_loc.T, z_loc), group).T
        # sender degrees: K4 over the sender-sorted order, then psum
        w_t = w_d.to(torch.float32)[layout.order_t]
        d_full = psum(segment_sum(w_t, layout.senders_t, n_pad,
                                  ids_sorted=True), group)
        n_valid = psum(m_loc.sum().to(s_loc.dtype), group)
        return _Primitives(
            s_full=s_full, mask_full=mask_full,
            node_graph=torch.zeros(n_pad, dtype=torch.int32, device=dev),
            d_full=d_full, x_pool=x_pool, adj_raw=adj_raw, n_valid=n_valid,
            s_d=s_d, r_glob=r_d.to(torch.int64) + row0, w_d=w_d,
            layout=layout, layout_t=layout_t, group=group)

    def finish(pr: _Primitives, losses):
        # pmean: every hook value is already the same on all ranks; its
        # backward hands each rank the cotangent the collectives expect
        losses = {k: pmean(v, group) for k, v in losses.items()}
        adj_pool = postprocess_adj_dense(
            pr.adj_raw[None],
            remove_self_loops_flag=pooler.remove_self_loops,
            degree_norm=pooler.degree_norm,
            edge_weight_norm=pooler.edge_weight_norm,
            adj_transpose=pooler.adj_transpose)[0]
        return pr.x_pool, adj_pool, losses

    def body(seed, x_loc, m_loc, s_d, r_d, w_d):
        lb = _local_view(x_loc, m_loc, rows_per, row0)
        with _selector_mode(pooler, not deterministic, seed,
                            group_rank(group), x_loc.device):
            so_loc = pooler.selector(lb)
        pr = primitives(so_loc.s, x_loc, m_loc, s_d, r_d, w_d)
        return finish(pr, hook(pooler, pr))

    def bn_body(seed, x_loc, m_loc, s_d, r_d, w_d, ns_d, nr_d, nm_d):
        lb = _local_view(x_loc, m_loc, rows_per, row0)
        # the sample seed is not folded with the rank: the draws are keyed
        # by global node index, as the single-device forward draws them
        with _selector_mode(pooler, not deterministic, seed,
                            group_rank(group), x_loc.device):
            so_loc = pooler.selector(lb, sample_seed=seed)
        kl_loc = pooler._kl_per_node(so_loc)
        pr = primitives(so_loc.s, x_loc, m_loc, s_d, r_d, w_d)

        # quality: BCE over the positive (local real) and negative
        # (sampled) edges, one mean over both.  A zero-weight real edge is
        # padding here, as in JAX.
        pos_mask = (pr.w_d != 0).to(torch.float32)
        neg_mask = nm_d.to(torch.float32)
        s_i, s_j = pr.pair_rows(pr.s_d, pr.r_glob)
        pos_logits = torch.sum(torch.matmul(s_i, pooler.K) * s_j, -1)
        n_i, n_j = pr.pair_rows(ns_d, nr_d)
        neg_logits = torch.sum(torch.matmul(n_i, pooler.K) * n_j, -1)
        rec_sum = pr.psum(
            torch.sum(L._bce_with_logits(pos_logits, 1.0) * pos_mask)
            + torch.sum(L._bce_with_logits(neg_logits, 0.0) * neg_mask))
        cnt = pr.psum(torch.sum(pos_mask) + torch.sum(neg_mask))
        cnt = torch.clamp(cnt, min=1.0)
        quality = rec_sum / cnt
        kl_sum = pr.psum(torch.sum(torch.where(m_loc, kl_loc, 0.0)))
        kl = kl_sum / cnt
        losses = {"quality": quality, "kl": pooler.eta * kl,
                  "K_prior": pooler._prior(cnt.reshape(1))}
        return finish(pr, losses)

    if kind == "bnpool":
        return bn_body
    if deterministic:
        return lambda x_loc, m_loc, s_d, r_d, w_d: body(
            None, x_loc, m_loc, s_d, r_d, w_d)
    return body
