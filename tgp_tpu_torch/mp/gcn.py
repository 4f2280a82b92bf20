"""GCN message passing on a sparse :class:`GraphBatch` (port of
``tgp_tpu/mp/gcn.py``: ``GCNConv`` and ``gcn_norm``).

Three branches, chosen as in the JAX layer:

* **static CSR** (receiver-sorted batch with the collator's ``row_ptr``,
  kernel regime): both ``D^{-1/2}`` factors fold into node space and the
  SpMM runs in the CUDA kernel (:func:`~tgp_tpu_torch.ops.kernels.
  segment_spmm.spmm_csr`); on a masked pooled graph the degree is one more
  kernel pass at width 1.
* **sorted, no CSR**: normalized messages summed by the sorted
  segment-sum kernel.
* **generic**: :func:`gcn_norm` + gather/scatter SpMM.

Self-loops follow ``add_remaining_self_loops`` in every branch: an
existing loop keeps its weight and only nodes without one get the unit
loop.  (The JAX CSR and sorted branches add a unit loop on top of an
existing one; the port holds all branches to ``gcn_norm``.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.ops.sparse import (
    add_remaining_self_loops,
    normalize_adj_sym,
    spmm,
    use_kernel_spmm,
)

__all__ = ["GCNConv", "gcn_norm"]

Tensor = torch.Tensor


def gcn_norm(batch: GraphBatch, add_self_loops: bool = True):
    """Symmetric GCN normalization ``D^{-1/2}(A+I)D^{-1/2}`` on masked COO.
    Returns ``(senders, receivers, weight)`` with the ``E+N`` budget when
    self-loops are added.  On a masked pooled graph (``node_mask_shrunk``)
    edges with an endpoint outside ``node_mask`` are zeroed first."""
    s, r, w, m = (batch.senders, batch.receivers, batch.edge_weight,
                  batch.edge_mask)
    nm = batch.node_mask
    if batch.node_mask_shrunk:
        m = m & nm[s.long()] & nm[r.long()]
        w = torch.where(m, w, 0.0)
    if add_self_loops:
        s, r, w, m = add_remaining_self_loops(s, r, w, m, nm, 1.0)
    w = normalize_adj_sym(s, r, w, m, batch.num_nodes)
    return s, r, w


def _unit_loops(batch: GraphBatch) -> Tensor:
    """``[N]`` bool: valid nodes that get an added unit self-loop (those
    without a valid loop edge of their own)."""
    has = batch.has_self_loop
    if has is None:
        loop = batch.edge_mask & (batch.senders == batch.receivers)
        has = segment_sum(loop.to(torch.int32), batch.senders,
                          batch.num_nodes) > 0
    return batch.node_mask & ~has


def _dinv(deg: Tensor) -> Tensor:
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)


class GCNConv(nn.Module):
    """GCN layer ``X' = D^{-1/2}(A+I)D^{-1/2} X W + b`` on a sparse batch.

    ``use_kernel``: ``None`` applies the regime map
    (:func:`~tgp_tpu_torch.ops.sparse.use_kernel_spmm`: sorted, E ≥ 2¹⁸,
    CUDA); ``True`` forces the sorted branches on a sorted batch (their
    kernels run their plain versions on CPU tensors); ``False`` forces the
    generic branch.  ``dtype``: matmul and SpMM compute dtype (weights stay
    f32), cast like flax's ``nn.Dense(dtype=...)``: input and weight in
    ``dtype``, output in ``dtype``; the f32 bias then promotes the output.
    """

    def __init__(self, in_channels: int, out_channels: int, *,
                 add_self_loops: bool = True, use_bias: bool = True,
                 use_kernel: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.add_self_loops = add_self_loops
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        nn.init.xavier_uniform_(self.lin.weight, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        self.to(device)

    def _linear(self, x: Tensor) -> Tensor:
        w = self.lin.weight
        ct = self.dtype or torch.promote_types(x.dtype, w.dtype)
        return torch.nn.functional.linear(x.to(ct), w.to(ct))

    def forward(self, batch: GraphBatch, x: Optional[Tensor] = None
                ) -> Tensor:
        if x is None:
            x = batch.x
        h = self._linear(x)
        want = self.use_kernel
        if want is None:
            want = use_kernel_spmm(batch.num_edges, batch.edges_sorted,
                                   h.device)
        if want and batch.edges_sorted:
            if batch.row_ptr is not None:
                out = self._csr(batch, h)
            else:
                out = self._sorted(batch, h)
        else:
            s, r, w = gcn_norm(batch, self.add_self_loops)
            out = spmm(s, r, w, h, batch.num_nodes)
        out = torch.where(batch.node_mask[:, None], out, 0.0)
        if self.bias is not None:
            out = out + self.bias
        return out

    def _csr(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """Static-CSR branch: one kernel SpMM (plus one width-1 kernel pass
        for the degree when the collator's ``in_degree`` is gone)."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

        N = batch.num_nodes
        nm = batch.node_mask
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0).to(
            torch.float32)
        if batch.in_degree is not None:
            deg = batch.in_degree.to(torch.float32)
        else:
            # masked/pooled graph: deg[r] = Σ |w_e| · m[send_e]
            deg = spmm_csr(nm.to(torch.float32)[:, None], w.abs(),
                           batch.senders, batch.row_ptr, N)[:, 0]
        if self.add_self_loops:
            unit = _unit_loops(batch).to(torch.float32)
            deg = deg + unit
        dinv = _dinv(deg) * nm.to(torch.float32)
        out = spmm_csr(h * dinv[:, None].to(h.dtype), w, batch.senders,
                       batch.row_ptr, N)
        out = out * dinv[:, None].to(out.dtype)
        if self.add_self_loops:
            out = out + h * (dinv * dinv * unit)[:, None].to(h.dtype)
        return out

    def _sorted(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """Receiver-sorted batch without CSR metadata: normalized messages
        through the sorted segment-sum kernel."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import segment_sum_sorted

        N = batch.num_nodes
        s, r = batch.senders.long(), batch.receivers.long()
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
        if batch.node_mask_shrunk:
            nm = batch.node_mask
            w = w * (nm[s] & nm[r])
        deg = segment_sum(w.abs(), r, N)
        if self.add_self_loops:
            unit = _unit_loops(batch).to(deg.dtype)
            deg = deg + unit
        dinv = _dinv(deg)
        msgs = h[s] * (w * dinv[s] * dinv[r])[:, None]
        out = segment_sum_sorted(msgs.contiguous(), batch.receivers, N)
        if self.add_self_loops:
            out = out + h * (dinv * dinv * unit)[:, None]
        return out
