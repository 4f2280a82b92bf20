"""MaxCut selection (port of ``tgp_tpu/select/maxcut.py``; Abate &
Bianchi, ICLR 2025).

:class:`MaxCutScoreNet`: a linear layer, a stack of propagations over
the δ-GCN matrix ``P = I − δ·L_sym = (1−δ)·I + δ·D^{-1/2} A D^{-1/2}``
(heterophilic), an MLP and a tanh score.  :class:`MaxCutSelect`: a
per-graph top-k on the score, upgraded to a total assignment by
:func:`~tgp_tpu_torch.ops.assignment.assign_all_nodes`; the scores ride
in ``extras["scores"]`` for the maxcut loss.

The propagation has two engines (``mp_impl``), as in JAX:

* ``"sparse"``: ``P``'s off-diagonal has ``A``'s pattern, so each round's
  product is K1 (:func:`~tgp_tpu_torch.ops.kernels.segment_spmm.spmm_csr`)
  with the weights ``δ·w·dinv[s]·dinv[r]`` over the collator's CSR layout
  (in the transpose order for the gradient), plus the diagonal as an
  elementwise term.  A batch without CSR metadata is sorted into that
  layout once a forward (:func:`delta_gcn_csr`).  Forward and backward add
  in a fixed order; JAX's COO SpMM over the appended loops adds in
  another, so the two agree within rounding.
* ``"dense"``: ``P`` densified per graph (duplicate entries summed in a
  fixed order by :func:`~tgp_tpu_torch.graph.to_dense`), each round a
  batched ``torch.matmul`` in f32.

``"auto"`` takes the dense engine when ``B·Nmax²`` fits
:data:`~tgp_tpu_torch.ops.sparse.DENSE_VOTE_BUDGET`.  The score net runs
in f32 whatever the features' dtype (flax promotes to its f32 weights).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch, to_dense
from tgp_tpu_torch.ops.assignment import assign_all_nodes
from tgp_tpu_torch.ops.lap import delta_gcn_diagonal, delta_gcn_matrix
from tgp_tpu_torch.ops.segment import node_cells
from tgp_tpu_torch.ops.sparse import use_dense_vote
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import topk_select_from_scores
from tgp_tpu_torch.utils.activations import resolve_activation
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["MaxCutScoreNet", "MaxCutSelect", "delta_gcn_csr"]

Tensor = torch.Tensor

_DEFAULT_MP = (32, 32, 32, 32, 16, 16, 16, 16, 8, 8, 8, 8)


def delta_gcn_csr(batch: GraphBatch, delta: float = 2.0):
    """``P`` on K1's layout: ``(layout, w, w_t, diag)`` with ``layout =
    (senders, receivers, row_ptr, receivers_t, senders_t, row_ptr_t,
    num_nodes)`` (the arguments of
    :func:`~tgp_tpu_torch.ops.kernels.segment_spmm.spmm_csr` around its
    weights), the off-diagonal weights ``δ·w·dinv[s]·dinv[r]`` in the
    receiver-sorted and the sender-sorted order, and the ``[N]``
    diagonal.  The collator's CSR metadata is used as it is; a batch
    without it is sorted receiver-major, then sender-major, here.  The
    degree (over the senders, as JAX's) is a fixed-order sum over the
    sender-sorted layout (K4)."""
    from tgp_tpu_torch.ops.kernels.segment_spmm import (csr_offsets,
                                                        sort_edges_csr,
                                                        sorted_segment_sum)

    N = batch.num_nodes
    if batch.row_ptr is not None:
        s, r, rp = batch.senders, batch.receivers, batch.row_ptr
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
        s_t, r_t, rp_t = batch.senders_t, batch.receivers_t, batch.row_ptr_t
        w_t = batch.edge_weight_t
    else:
        # valid edges first, by receiver; masked ones past row_ptr[N]
        s, r, w, rp = sort_edges_csr(batch.senders, batch.receivers,
                                     batch.edge_weight, batch.edge_mask, N)
        valid = torch.arange(s.shape[0], device=s.device) < rp[N]
        key_t, perm = torch.sort(torch.where(valid, s.long(), N),
                                 stable=True)
        s_t, r_t, w_t = s[perm], r[perm], w[perm]
        rp_t = csr_offsets(key_t, N)
    w, w_t = w.to(torch.float32), w_t.to(torch.float32)
    deg = sorted_segment_sum(w_t[:, None].contiguous(), None, rp_t, N)[:, 0]
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                       0.0)

    def off(wv, sv, rv):
        return delta * wv * dinv[sv.long().clamp(0, N - 1)] \
            * dinv[rv.long().clamp(0, N - 1)]

    layout = (s, r, rp, r_t, s_t, rp_t, N)
    return (layout, off(w, s, r), off(w_t, s_t, r_t),
            delta_gcn_diagonal(deg, batch.node_mask, delta))


class MaxCutScoreNet(nn.Module):
    """``[N]`` scores in ``[−1, 1]`` (``act``).  ``layers`` are flax's
    ``Dense_0…``: the input layer (``in_channels`` wide, with bias), one
    per propagation round (no bias; ``mp_bias[i]`` is ``mp_bias_i``, added
    after the product), the MLP's and the score's."""

    def __init__(self, in_channels: int, mp_units: Sequence[int] = _DEFAULT_MP,
                 mp_act: str = "tanh", mlp_units: Sequence[int] = (16, 16),
                 mlp_act: str = "relu", act: str = "tanh",
                 delta: float = 2.0, mp_impl: str = "auto", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not in_channels:
            raise ValueError("MaxCutScoreNet needs in_channels (the input "
                             "width)")
        if mp_impl not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown mp_impl {mp_impl!r}")
        self.mp_units = tuple(mp_units)
        self.mp_act = resolve_activation(mp_act)
        self.mlp_act = resolve_activation(mlp_act)
        self.act = resolve_activation(act)
        self.delta = delta
        self.mp_impl = mp_impl
        widths = [in_channels, in_channels, *self.mp_units, *mlp_units, 1]
        n_mp = len(self.mp_units)
        self.layers = nn.ModuleList(
            lecun_normal_linear(a, b, bias=not 1 <= i <= n_mp,
                                generator=generator)
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])))
        self.mp_bias = nn.ParameterList(
            nn.Parameter(torch.zeros(u)) for u in self.mp_units)
        self.to(resolve_device(device))

    def engine(self, batch: GraphBatch) -> str:
        if self.mp_impl != "auto":
            return self.mp_impl
        return ("dense" if use_dense_vote(batch.num_graphs, batch.max_nodes)
                else "sparse")

    def forward(self, batch: GraphBatch) -> Tensor:
        from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

        n_mp = len(self.mp_units)
        lin_in, mp_lins = self.layers[0], self.layers[1:1 + n_mp]
        x = apply_linear(lin_in, batch.x.to(torch.float32))
        dense = self.engine(batch) == "dense"
        if dense:
            s, r, w, m = delta_gcn_matrix(
                batch.senders, batch.receivers, batch.edge_weight,
                batch.edge_mask, batch.node_mask, batch.num_nodes, self.delta)
            d = to_dense(batch.replace(x=x, senders=s, receivers=r,
                                       edge_weight=torch.where(m, w, 0.0),
                                       edge_mask=m))
            # to_dense's adj is sender-major: P[b, n, m] = adj[b, m, n]
            P, x = d.adj.transpose(1, 2), d.x
            for lin, b in zip(mp_lins, self.mp_bias):
                x = self.mp_act(torch.matmul(P, apply_linear(lin, x)) + b)
        else:
            layout, w, w_t, diag = delta_gcn_csr(batch, self.delta)
            for lin, b in zip(mp_lins, self.mp_bias):
                h = apply_linear(lin, x).contiguous()
                h = spmm_csr(h, w, w_t, *layout[:6], batch.num_nodes) \
                    + diag[:, None] * h
                x = self.mp_act(h + b)
        for lin in self.layers[1 + n_mp:-1]:
            x = self.mlp_act(apply_linear(lin, x))
        score = self.act(apply_linear(self.layers[-1], x)[..., 0])
        if dense:
            # padding nodes read their graph's last cell; their scores are
            # masked by the caller, so their gradient is 0
            score = score.reshape(-1)[node_cells(
                batch.node_graph, batch.node_pos, batch.max_nodes)]
        return score


class MaxCutSelect(nn.Module):
    """Score (:class:`MaxCutScoreNet`, flax's ``MaxCutScoreNet_0``),
    per-graph top-``ratio`` selection and, with ``do_assign_all_nodes``,
    ``max_iter`` propagation rounds to a total assignment weighted by the
    scores (the voting engine follows ``mp_impl``; the in-graph fallback
    is the first occupied supernode, as in JAX)."""

    def __init__(self, in_channels: int, ratio: Union[int, float] = 0.5,
                 do_assign_all_nodes: bool = True, max_iter: int = 5,
                 mp_units: Sequence[int] = _DEFAULT_MP, mp_act: str = "tanh",
                 mlp_units: Sequence[int] = (16, 16), mlp_act: str = "relu",
                 act: str = "tanh", delta: float = 2.0,
                 min_score: Optional[float] = None,
                 s_inv_op: str = "transpose", mp_impl: str = "auto", *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ratio = ratio
        self.do_assign_all_nodes = do_assign_all_nodes
        self.max_iter = max_iter
        self.min_score = min_score
        self.s_inv_op = s_inv_op
        self.mp_impl = mp_impl
        self.score_net = MaxCutScoreNet(
            in_channels, mp_units, mp_act, mlp_units, mlp_act, act, delta,
            mp_impl, device=device, generator=generator)

    def forward(self, batch: GraphBatch) -> SelectOutput:
        scores = torch.where(batch.node_mask, self.score_net(batch), 0.0)
        so = topk_select_from_scores(scores, batch, self.ratio,
                                     self.min_score, self.s_inv_op)
        if self.do_assign_all_nodes:
            so = assign_all_nodes(
                so, batch.senders, batch.receivers, batch.edge_mask,
                max_iter=self.max_iter, weight=scores,
                node_pos=batch.node_pos, max_nodes=batch.max_nodes,
                impl=self.mp_impl)
        return so.with_extra(scores=scores)
