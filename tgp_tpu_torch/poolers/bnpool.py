"""BNPool, Bayesian nonparametric pooling (port of
``tgp_tpu/poolers/bnpool.py``; Castellana & Bianchi 2025).

:class:`~tgp_tpu_torch.select.dp.DPSelect` (a stick-breaking posterior),
the dense reduce ``SᵀX`` and connect ``SᵀAS``, with a learnable
cluster-connectivity matrix ``K`` and three losses: ``quality`` (the
class-balanced BCE of ``A_rec = S K Sᵀ``; unbatched, over the edges and
as many sampled non-edges), ``kl`` (η·KL(q ‖ Beta(1, α_DP))) and
``K_prior`` (Gaussian).  The Beta draws are made at train and eval time
alike, from ``sample_generator``, as JAX draws from its ``"sample"``
stream; the unbatched loss's negatives come from it too, unless the
caller hands them in (``negatives=``).  Everything runs in f32; ``S K
Sᵀ``, ``SᵀX`` and ``SᵀAS`` are ``torch.matmul`` (JAX's ``einsum``, no
Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.connect.base import dense_connect, dense_connect_unbatched
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.losses import (beta_kl_divergence,
                                  cluster_connectivity_prior_loss, kl_loss,
                                  sparse_bce_reconstruction_loss,
                                  weighted_bce_reconstruction_loss)
from tgp_tpu_torch.ops.sampling import (cap_samples_per_graph,
                                        negative_edge_sampling)
from tgp_tpu_torch.ops.segment import gather_rows
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.reduce.base import (reduce_dense_batched,
                                       reduce_dense_unbatched)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.dp import DPSelect
from tgp_tpu_torch.src import DenseSRCPooling, PoolingOutput

__all__ = ["BNPool"]

Tensor = torch.Tensor


def _signed_eye(k: int, value: float, device) -> Tensor:
    """``value`` on the diagonal, ``−value`` off it."""
    eye = torch.eye(k, device=device)
    return value * eye - value * (1 - eye)


class BNPool(DenseSRCPooling):
    """``"bnpool"`` (``batched=False``: ``"bnpool_u"``).  ``K`` is a
    parameter (flax's ``pooler/K``) that takes a gradient only with
    ``train_K``.  ``generator`` draws the selector's weights,
    ``dropout_generator`` its dropout, ``sample_generator`` the Beta
    draws and the negatives.  ``num_neg_samples`` caps the negatives per
    graph (unbatched).  ``per_node_keys`` keys each node's draws by its
    identity (:class:`~tgp_tpu_torch.select.dp.DPSelect`), so the sharded
    forward (``parallel/dense_pool.py``) draws what this one does;
    ``forward``'s ``sample_seed`` then sets the base seed of the draws."""

    IS_TRAINABLE = True
    HAS_LOSS = True

    def __init__(self, in_channels: Union[int, List[int], None] = None,
                 k: int = 8, alpha_DP: float = 1.0, K_var: float = 1.0,
                 K_mu: float = 10.0, K_init: float = 1.0, eta: float = 1.0,
                 train_K: bool = True,
                 num_neg_samples: Optional[int] = None,
                 per_node_keys: bool = False, act: Optional[str] = None,
                 dropout: float = 0.0, remove_self_loops: bool = True,
                 degree_norm: bool = True, edge_weight_norm: bool = False,
                 adj_transpose: bool = False, s_inv_op: str = "transpose",
                 batched: bool = True, sparse_output: bool = False,
                 lift_op: str = "precomputed", lift_red_op: str = "sum", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None,
                 sample_generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        device = resolve_device(device)
        self.k = k
        self.alpha_DP = alpha_DP
        self.K_var = K_var
        self.K_mu = K_mu
        self.eta = eta
        self.train_K = train_K
        self.num_neg_samples = num_neg_samples
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.adj_transpose = adj_transpose
        self.batched = batched
        self.sparse_output = sparse_output
        self.sample_generator = sample_generator
        self.selector = DPSelect(
            in_channels, k, batched, act, dropout, s_inv_op, per_node_keys,
            device=device, generator=generator,
            dropout_generator=dropout_generator,
            sample_generator=sample_generator)
        self.K = nn.Parameter(_signed_eye(k, K_init, device),
                              requires_grad=train_K)
        self.to(device)

    def _kl_per_node(self, so: SelectOutput) -> Tensor:
        a_q, b_q = so.extras["q_alpha"], so.extras["q_beta"]
        a_p = torch.ones(self.k - 1, device=a_q.device)
        return beta_kl_divergence(a_q, b_q, a_p, a_p * self.alpha_DP).sum(-1)

    def _prior(self, cnt: Tensor) -> Tensor:
        if not self.train_K:
            return torch.zeros((), device=cnt.device)
        return cluster_connectivity_prior_loss(
            self.K, _signed_eye(self.k, self.K_mu, self.K.device),
            self.K_var, normalizing_const=cnt)

    def compute_loss(self, dense: DenseGraphBatch, so: SelectOutput
                     ) -> Dict[str, Tensor]:
        s = so.s
        rec_adj = torch.matmul(torch.matmul(s, self.K), s.transpose(1, 2))
        n = dense.mask.sum(-1)
        # clipped: an all-padding graph gives 0, not 0/0
        n2 = torch.clamp((n * n).to(s.dtype), min=1.0)
        rec = weighted_bce_reconstruction_loss(
            rec_adj, dense.adj, mask=dense.mask, balance_links=True,
            normalizing_const=n2)
        kl = kl_loss(self._kl_per_node(so), mask=dense.mask,
                     normalizing_const=n2)
        return {"quality": rec, "kl": self.eta * kl,
                "K_prior": self._prior(n2)}

    def compute_sparse_loss(self, batch: GraphBatch, so: SelectOutput,
                            negatives=None) -> Dict[str, Tensor]:
        """``negatives = (senders, receivers, mask)``: sampled non-edges
        to use in place of new draws."""
        s = so.s
        if negatives is None:
            neg_s, neg_r, neg_m = negative_edge_sampling(
                batch, self.sample_generator)
            if self.num_neg_samples is not None:
                neg_m = cap_samples_per_graph(
                    neg_m, batch.node_graph[neg_s.long()], batch.num_graphs,
                    self.num_neg_samples)
        else:
            neg_s, neg_r, neg_m = negatives
        N = batch.num_nodes
        all_s = torch.cat([batch.senders, neg_s.to(batch.senders.dtype)])
        all_r = torch.cat([batch.receivers, neg_r.to(batch.senders.dtype)])
        all_m = torch.cat([batch.edge_mask, neg_m])
        logits = (torch.matmul(gather_rows(s, all_s, N), self.K)
                  * gather_rows(s, all_r, N)).sum(-1)
        y = torch.cat([torch.ones(batch.num_edges, device=s.device),
                       torch.zeros(neg_s.shape[0], device=s.device)])
        rec, cnt = sparse_bce_reconstruction_loss(
            logits, y, edges_graph=batch.node_graph[all_s.long()],
            num_graphs=batch.num_graphs, sample_mask=all_m)
        kl = kl_loss(self._kl_per_node(so), node_graph=batch.node_graph,
                     num_graphs=batch.num_graphs, node_mask=batch.node_mask,
                     normalizing_const=cnt)
        return {"quality": rec, "kl": self.eta * kl,
                "K_prior": self._prior(cnt)}

    def forward(self, batch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[Tensor] = None,
                negatives=None, sample_seed: Optional[int] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if self.batched:
            dense = self.ensure_dense(batch, self.adj_transpose)
            if so is None:
                so = self.selector(dense, sample_seed=sample_seed)
            x_pool = reduce_dense_batched(dense.x, so.s)
            adj_pool = dense_connect(dense.adj, so.s)
            loss = self.compute_loss(dense, so)
        else:
            if not isinstance(batch, GraphBatch):
                raise TypeError("an unbatched BNPool expects a flat "
                                "GraphBatch")
            if so is None:
                so = self.selector(batch, sample_seed=sample_seed)
            loss = self.compute_sparse_loss(batch, so, negatives)
            place = dict(node_pos=batch.node_pos, max_nodes=batch.max_nodes)
            x_pool = reduce_dense_unbatched(
                batch.x, so.s, batch.node_graph, batch.num_graphs,
                batch.node_mask, **place)
            adj_pool = dense_connect_unbatched(
                batch.senders, batch.receivers, batch.edge_weight, so.s,
                batch.node_graph, batch.num_graphs, batch.node_mask, **place)
        adj_pool = postprocess_adj_dense(
            adj_pool, remove_self_loops_flag=self.remove_self_loops,
            degree_norm=self.degree_norm,
            edge_weight_norm=self.edge_weight_norm,
            adj_transpose=self.adj_transpose)
        out = DenseGraphBatch(x=x_pool, adj=adj_pool, mask=so.out_mask())
        if self.sparse_output:
            return PoolingOutput(so=so, graph=self.finalize_sparse_output(out),
                                 loss=loss)
        return PoolingOutput(so=so, dense=out, loss=loss)
