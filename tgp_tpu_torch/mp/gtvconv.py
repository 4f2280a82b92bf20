"""GTVConv: graph total-variation convolution (port of
``tgp_tpu/mp/gtvconv.py``; Hansen & Bianchi, ICML 2023; with
AsymCheegerCut pooling it makes TVGNN).

``out = act((I − δ·L_Γ) X W + b)``, where Γ reweights each edge by
``w_ij / max(|x_iW − x_jW|₁, ε)``.  The aggregation is at the SENDERS
(``(D_Γ h)[s] = Σ_{e: send=s} γ_e``, ``(Γ h)[s] = Σ γ_e · h[recv_e]``),
the transpose of ``GCNConv``'s flow, so that the sparse branch is the
dense ``(I − δL_Γ) h`` row aggregation.

Three routes:

* **dense** (:class:`DenseGraphBatch`): JAX's ``[B, N, N]`` math, masked
  by ``batch.mask``.  It builds ``|h_i − h_j|`` as a ``[B, N, N, F]``
  tensor, so it is for small graphs.
* **generic** (sparse): γ from row gathers (:func:`~tgp_tpu_torch.ops.
  segment.gather_rows`, whose gradient sums in a fixed order), and
  ``deg`` and ``Γh`` by :func:`~tgp_tpu_torch.ops.segment.segment_sum`
  over the senders (a stable sort, then K4).
* **CSR** (sparse, where ``GCNConv`` takes its CSR branch: the regime
  map :func:`~tgp_tpu_torch.ops.sparse.use_kernel_spmm` and the
  collator's ``row_ptr``): K1 (:func:`~tgp_tpu_torch.ops.kernels.
  segment_spmm.spmm_csr`) over the collator's sender-sorted transpose
  layout, with γ in that order as its weights; its gradient for ``h``
  runs over the receiver-sorted layout (γ put back in that order by the
  stable sort that made the transpose), and γ's gradient is K1's
  ``d_w``.  ``deg`` is a width-1 K1 pass over the same layout.  A kernel
  that fails to build or launch raises; there is no fallback.

Every route gives the same bits run to run: no float sum adds in an
order the card picks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.ops.segment import gather_rows, segment_sum
from tgp_tpu_torch.ops.sparse import spmm_route
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["GTVConv"]

Tensor = torch.Tensor


def _gamma(hs: Tensor, hr: Tensor, w: Tensor, eps: float) -> Tensor:
    """``w / max(|hs − hr|₁, eps)`` per edge."""
    return w / torch.clamp((hs - hr).abs().sum(-1), min=eps)


class GTVConv(nn.Module):
    """``act((I − δ·L_Γ) X W + b)``; ``weight [in, out]`` and ``bias
    [out]`` as the flax layer names them (the kernel initialised like
    flax's ``kaiming_normal``, the bias zero).  The fields are JAX's:
    ``out_channels``, ``delta_coeff``, ``eps``, ``act``, ``use_bias``;
    ``in_channels`` is the input width."""

    def __init__(self, in_channels: int, out_channels: int,
                 delta_coeff: float = 1.0, eps: float = 1e-3,
                 act: Optional[str] = "relu", use_bias: bool = True, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels = out_channels
        self.delta_coeff = delta_coeff
        self.eps = eps
        self.act = act
        self.use_bias = use_bias
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        # flax's kaiming_normal: a [-2, 2]-truncated normal rescaled to
        # variance 2/fan_in
        std = math.sqrt(2.0 / in_channels) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        self.to(device)

    def forward(self, batch, x: Optional[Tensor] = None) -> Tensor:
        if x is None:
            x = batch.x
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        h = torch.matmul(x.to(ct), self.weight.to(ct))
        if isinstance(batch, DenseGraphBatch):
            out = self._dense(batch, h)
        else:
            if spmm_route(batch) == "csr":
                out = self._csr(batch, h)
            else:
                out = self._generic(batch, h)
            if self.bias is not None:
                out = out + self.bias
            out = torch.where(batch.node_mask[:, None], out, 0.0)
        return resolve_activation(self.act)(out)

    def _dense(self, batch: DenseGraphBatch, h: Tensor) -> Tensor:
        """``(I − δL_Γ) h`` with ``Γ [B, N, N]`` from the pairwise
        ``|h_i − h_j|₁`` where ``adj != 0``."""
        adj = batch.adj
        diff = (h[:, :, None, :] - h[:, None, :, :]).abs().sum(-1)
        gamma = adj / torch.clamp(diff, min=self.eps)
        gamma = torch.where(adj != 0, gamma, 0.0)
        deg = gamma.sum(-1)
        eye = torch.eye(adj.shape[-1], dtype=h.dtype, device=h.device)
        lap = -gamma + deg[..., None] * eye
        mod = -self.delta_coeff * lap + eye
        out = torch.matmul(mod, h)
        if self.bias is not None:
            out = out + self.bias
        return out * batch.mask[..., None].to(out.dtype)

    def _generic(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """Gathers and fixed-order segment sums over the senders."""
        N = batch.num_nodes
        s = batch.senders
        hr = gather_rows(h, batch.receivers, N)
        gamma = _gamma(gather_rows(h, s, N), hr, batch.edge_weight,
                       self.eps)
        gamma = torch.where(batch.edge_mask, gamma, 0.0)
        deg = segment_sum(gamma, s, N)
        neigh = segment_sum(gamma[:, None] * hr, s, N)
        return h - self.delta_coeff * (deg[:, None] * h - neigh)

    def _csr(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """K1 over the transpose layout (rows = senders).  ``gamma``, the
        weight of the gradient's pass over the receiver-sorted layout, is
        ``gamma_t`` put back in that order (the collator's transpose is a
        stable sort of the receiver-sorted edges by sender) and takes no
        gradient itself."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

        N = batch.num_nodes
        s_t, r_t = batch.senders_t, batch.receivers_t
        # the collator's edge_weight_t is zero on padding edges
        gamma_t = _gamma(gather_rows(h, s_t, N), gather_rows(h, r_t, N),
                         batch.edge_weight_t.to(h.dtype),
                         self.eps).to(torch.float32)
        perm = torch.sort(batch.senders, stable=True).indices
        gamma = torch.empty_like(gamma_t).index_copy_(0, perm,
                                                      gamma_t.detach())
        layout = (r_t, s_t, batch.row_ptr_t, batch.senders, None,
                  batch.row_ptr, N)
        ones = torch.ones(N, 1, dtype=h.dtype, device=h.device)
        deg = spmm_csr(ones, gamma_t, gamma, *layout)[:, 0]
        neigh = spmm_csr(h.contiguous(), gamma_t, gamma, *layout)
        return h - self.delta_coeff * (deg[:, None] * h - neigh)
