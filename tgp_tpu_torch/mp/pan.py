"""PANConv, the path-integral (MET-matrix) convolution (port of
``tgp_tpu/mp/pan.py``).

The MET matrix is ``M = Σ_{l=0}^{L} w_l A^l`` (learnable hop weights
``hop_weight``, hop 0 through ``filter_size``), symmetrically normalized
``D_M^{-1/2} M D_M^{-1/2}`` when ``normalize``.  ``M`` is never built
sparsely: the features take ``M X W`` by iterated SpMM, and the pooling
score's MET degree (column sums of the normalized ``M``) likewise.  With
``exact_met_support`` or ``return_dense_met`` the per-graph dense powers
``A^l`` (``[B, Nmax, Nmax]`` products, ``torch.matmul``, as the JAX
package's ``einsum``) give the exact MET value of each edge, and the whole
dense ``M`` for :class:`~tgp_tpu_torch.poolers.pan.PANPooling`'s exact
connect; otherwise each edge keeps its hop-1 term.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch, to_dense
from tgp_tpu_torch.ops.sparse import spmm
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["PANConv"]

Tensor = torch.Tensor


class PANConv(nn.Module):
    """Returns ``(x_out [N, out], met_degree [N], met_edge_weight [E])``,
    and ``met_dense [B, Nmax, Nmax]`` (hop 0's diagonal included) as a
    fourth item with ``return_dense_met``.  ``lin`` is the flax layer's
    ``Dense_0``; ``M[i, j]`` weighs the edge ``i → j``, as the dense
    ``adj[pos_s, pos_r]`` does."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_size: int = 3, use_bias: bool = True,
                 normalize: bool = True, exact_met_support: bool = True,
                 return_dense_met: bool = False, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.filter_size = filter_size
        self.normalize = normalize
        self.exact_met_support = exact_met_support
        self.return_dense_met = return_dense_met
        # hops 0..L, filled 0.5 as PyG's panentropy weight
        self.hop_weight = nn.Parameter(torch.full((filter_size + 1,), 0.5))
        self.lin = lecun_normal_linear(in_channels, out_channels, bias=False,
                                       generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        self.to(resolve_device(device))

    def forward(self, batch: GraphBatch, x: Optional[Tensor] = None
                ) -> Tuple[Tensor, ...]:
        if x is None:
            x = batch.x
        L = self.filter_size
        w = self.hop_weight
        s, r = batch.senders, batch.receivers
        ew = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
        N = batch.num_nodes
        nm = batch.node_mask

        def met_mv(v, transpose=False):
            """``M v`` (``Mᵀ v`` with ``transpose``) by iterated SpMM."""
            acc = w[0] * v
            cur = v
            for l in range(1, L + 1):
                cur = (spmm(s, r, ew, cur, N) if transpose
                       else spmm(r, s, ew, cur, N))
                acc = acc + w[l] * cur
            return acc

        ones = torch.ones(N, 1, dtype=x.dtype, device=x.device)
        deg = torch.where(nm, met_mv(ones)[:, 0], 0.0)
        if self.normalize:
            dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
            dinv = torch.where(nm & (deg > 0), dinv, 0.0)
        else:
            dinv = torch.ones_like(deg)

        h = apply_linear(self.lin, x)
        out = dinv[:, None] * met_mv(dinv[:, None] * h)
        if self.bias is not None:
            out = out + self.bias
        out = torch.where(nm[:, None], out, 0.0)

        # the pooling score's MET degree: column sums of the normalized M
        if self.normalize:
            met_degree = dinv * met_mv(dinv[:, None], transpose=True)[:, 0]
        else:
            met_degree = met_mv(ones, transpose=True)[:, 0]
        met_degree = torch.where(nm, met_degree, 0.0)

        if not (self.return_dense_met or self.exact_met_support):
            # hop 1 only (hop 0 is the diagonal)
            met_w = w[1] * ew if L >= 1 else torch.zeros_like(ew)
            if self.normalize:
                met_w = met_w * dinv[s.long()] * dinv[r.long()]
            return out, met_degree, met_w

        d = to_dense(batch)
        adj = d.adj
        eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
        met = w[0] * eye * d.mask.to(adj.dtype)[:, :, None]
        cur = None
        for l in range(1, L + 1):
            cur = adj if cur is None else torch.matmul(cur, adj)
            met = met + w[l] * cur
        g, p = batch.node_graph.long(), batch.node_pos.long()
        if self.normalize:
            # each valid node owns its cell: an indexed write (masked
            # nodes write to a spare cell past the end)
            B, Nm = adj.shape[:2]
            cell = torch.where(nm, g * Nm + p, B * Nm)
            dv = adj.new_zeros(B * Nm + 1).index_put((cell,), dinv)
            dv = dv[:-1].view(B, Nm)
            met = dv[:, :, None] * met * dv[:, None, :]
        met_w = torch.where(batch.edge_mask,
                            met[g[s.long()], p[s.long()], p[r.long()]], 0.0)
        if self.return_dense_met:
            return out, met_degree, met_w, met
        return out, met_degree, met_w
