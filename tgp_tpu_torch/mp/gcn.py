"""GCN message passing (port of ``tgp_tpu/mp/gcn.py``: ``GCNConv``,
``GraphConv``, ``gcn_norm`` and ``gcn_norm_dense``).

On a :class:`DenseGraphBatch` the layer is one batched ``[B,N,N]@[B,N,F]``
product: the K3 kernel (:func:`~tgp_tpu_torch.ops.kernels.bmm.bmm`, f32
out) with ``use_kernel=True``, else ``torch.matmul`` with the JAX einsum's
dtype rule.  On a sparse :class:`GraphBatch`, three branches, chosen as in
the JAX layer:

* **static CSR** (receiver-sorted batch with the collator's ``row_ptr``,
  kernel regime): both ``D^{-1/2}`` factors fold into node space and the
  SpMM runs in the CUDA kernel (:func:`~tgp_tpu_torch.ops.kernels.
  segment_spmm.spmm_csr`), whose gradient is the same kernel over the
  collator's sender-sorted transpose layout; on a masked pooled graph the
  degree is one more kernel pass at width 1.
* **sorted, no CSR**: normalized messages summed by the sorted
  segment-sum kernel (K2), the degree too: both in a fixed order.  A
  clustering pooler's merged pooled graph takes it (its edges ascend by
  receiver) in the kernel regime.
* **generic**: :func:`gcn_norm` + gather/scatter SpMM.

Self-loops follow ``add_remaining_self_loops`` in every branch: an
existing loop keeps its weight and only nodes without one get the unit
loop.  (The JAX CSR and sorted branches add a unit loop on top of an
existing one; the port holds all branches to ``gcn_norm``.)

``GraphConv`` (``X' = W₁X + b + W₂·AX``, SAG's default scorer) propagates
``AX`` at the input width: in the CUDA kernel over the collator's CSR
layout in the same regime as ``GCNConv``, else by gather + segment-sum.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.ops.segment import segment_sum
from tgp_tpu_torch.ops.sparse import (
    add_remaining_self_loops,
    normalize_adj_sym,
    spmm,
    use_kernel_spmm,
)
from tgp_tpu_torch.utils.linear import apply_linear, lecun_normal_linear

__all__ = ["GCNConv", "GraphConv", "gcn_norm", "gcn_norm_dense"]

Tensor = torch.Tensor


def _self_loops_dense(adj: Tensor, mask: Tensor) -> Tensor:
    """``A + I`` on valid nodes only."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    return adj + eye * mask.to(adj.dtype)[:, :, None]


def _sym_norm_dense(adj: Tensor) -> Tensor:
    """``D^{-1/2} A D^{-1/2}`` with degrees from ``|A|`` (clamped at
    1e-12), in ``adj``'s dtype."""
    dinv = torch.rsqrt(torch.clamp(adj.abs().sum(-1), min=1e-12))
    return dinv[..., :, None] * adj * dinv[..., None, :]


def gcn_norm_dense(dense: DenseGraphBatch, *, add_self_loops: bool = True,
                   adj_dtype: Optional[torch.dtype] = None
                   ) -> DenseGraphBatch:
    """GCN-normalize a dense adjacency once, outside the train step:
    ``D^{-1/2}(A+I)D^{-1/2}`` on valid nodes, abs degrees, optionally cast
    to ``adj_dtype`` (bf16 halves the ``[B,N,N]`` traffic).  Pair with
    ``GCNConv(normalize=False)`` / ``pre_normalized=True``."""
    adj = dense.adj
    if add_self_loops:
        adj = _self_loops_dense(adj, dense.mask)
    adj = _sym_norm_dense(adj)
    if adj_dtype is not None:
        adj = adj.to(adj_dtype)
    return dense.replace(adj=adj)


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
    """GCN layer ``X' = D^{-1/2}(A+I)D^{-1/2} X W + b``.

    Sparse input: ``use_kernel``: ``None`` applies the regime map
    (:func:`~tgp_tpu_torch.ops.sparse.use_kernel_spmm`: sorted, E ≥ 2¹⁸,
    CUDA); ``True`` forces the sorted branches on a sorted batch (their
    kernels run their plain versions on CPU tensors); ``False`` forces the
    generic branch.  ``dtype``: matmul and SpMM compute dtype (weights stay
    f32), cast like flax's ``nn.Dense(dtype=...)``: input and weight in
    ``dtype``, output in ``dtype``; the f32 bias then promotes the output.

    Dense input: ``normalize`` adds self-loops on valid nodes and
    normalizes the adjacency in its own dtype (False when it is
    pre-normalized); ``use_kernel=True`` runs the K3 kernel (operands
    rounded to bf16, f32 out), anything else ``torch.matmul`` of the
    adjacency cast to ``h``'s dtype (f32 out without ``dtype``, else
    ``dtype`` out); ``mask_output`` zeroes padding rows.
    """

    def __init__(self, in_channels: int, out_channels: int, *,
                 add_self_loops: bool = True, use_bias: bool = True,
                 use_kernel: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None,
                 normalize: bool = True, mask_output: bool = True,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.add_self_loops = add_self_loops
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.normalize = normalize
        self.mask_output = mask_output
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        nn.init.xavier_uniform_(self.lin.weight, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        self.to(device)

    def _linear(self, x: Tensor) -> Tensor:
        w = self.lin.weight
        ct = self.dtype or torch.promote_types(x.dtype, w.dtype)
        return torch.nn.functional.linear(x.to(ct), w.to(ct))

    def forward(self, batch, x: Optional[Tensor] = None) -> Tensor:
        if x is None:
            x = batch.x
        h = self._linear(x)
        if isinstance(batch, DenseGraphBatch):
            out = self._dense(batch, h)
        else:
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

    def _dense(self, batch: DenseGraphBatch, h: Tensor) -> Tensor:
        """Dense branch (``gcn.py:190-216``): one batched adjacency
        product."""
        adj = batch.adj
        if self.normalize:
            if self.add_self_loops:
                adj = _self_loops_dense(adj, batch.mask)
            adj = _sym_norm_dense(adj)
        if self.use_kernel:
            from tgp_tpu_torch.ops.kernels.bmm import bmm

            out = bmm(adj.contiguous(), h.contiguous())
        else:
            # the adjacency takes h's dtype; f32 h gives an f32 product and
            # bf16 h (dtype=bf16) a bf16 one, as the JAX einsum's
            # preferred_element_type does
            out = torch.matmul(adj.to(h.dtype), h)
        if self.mask_output:
            out = torch.where(batch.mask[..., None], out, 0.0)
        return out

    def _csr(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """Static-CSR branch: one kernel SpMM (plus one width-1 kernel pass
        for the degree when the collator's ``in_degree`` is gone); the
        SpMM's gradient runs the kernel over the collator's transpose
        layout."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

        N = batch.num_nodes
        nm = batch.node_mask
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0).to(
            torch.float32)
        # zero on padding edges, and on the edges masked pooling removed
        w_t = (None if batch.edge_weight_t is None
               else batch.edge_weight_t.to(torch.float32))
        layout = (batch.senders, batch.receivers, batch.row_ptr,
                  batch.receivers_t, batch.senders_t, batch.row_ptr_t, N)
        if batch.in_degree is not None:
            deg = batch.in_degree.to(torch.float32)
        else:
            # masked/pooled graph: deg[r] = Σ |w_e| · m[send_e]
            deg = spmm_csr(nm.to(torch.float32)[:, None], w.abs(),
                           None if w_t is None else w_t.abs(), *layout)[:, 0]
        if self.add_self_loops:
            unit = _unit_loops(batch).to(torch.float32)
            deg = deg + unit
        dinv = _dinv(deg) * nm.to(torch.float32)
        out = spmm_csr(h * dinv[:, None].to(h.dtype), w, w_t, *layout)
        out = out * dinv[:, None].to(out.dtype)
        if self.add_self_loops:
            out = out + h * (dinv * dinv * unit)[:, None].to(h.dtype)
        return out

    def _sorted(self, batch: GraphBatch, h: Tensor) -> Tensor:
        """Receiver-sorted batch without CSR metadata: the degree and the
        normalized messages through the sorted segment-sum kernel (K2), in
        a fixed order, over one set of offsets."""
        from tgp_tpu_torch.ops.kernels.segment_spmm import (build_row_ptr,
                                                            segment_sum_sorted)

        N = batch.num_nodes
        s, r = batch.senders.long(), batch.receivers.long()
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
        if batch.node_mask_shrunk:
            nm = batch.node_mask
            w = w * (nm[s] & nm[r])
        # one set of offsets for both sums; as segment_sum does, receivers
        # outside [0, N) add nothing (those in [N, rows_pad) land in rows
        # past N, the rest are not counted)
        row_ptr = build_row_ptr(batch.receivers, N)
        deg = segment_sum_sorted(w.abs().to(torch.float32)[:, None].contiguous(),
                                 batch.receivers, N, row_ptr)[:, 0]
        if self.add_self_loops:
            unit = _unit_loops(batch).to(deg.dtype)
            deg = deg + unit
        dinv = _dinv(deg)
        # index_select: its gradient is one index_add_ (h[s]'s is a sort
        # and a serial pass over each run of repeated senders)
        msgs = h.index_select(0, s) * (w * dinv[s] * dinv[r])[:, None]
        out = segment_sum_sorted(msgs.contiguous(), batch.receivers, N,
                                 row_ptr)
        if self.add_self_loops:
            out = out + h * (dinv * dinv * unit)[:, None]
        return out


class GraphConv(nn.Module):
    """``X' = W₁X + b + W₂·(A X)`` (PyG's ``GraphConv``; SAG's default
    scorer), output zero on masked nodes.  ``lin`` and ``lin_1`` are the
    flax layer's ``Dense_0`` (root, with bias) and ``Dense_1``
    (neighbours), both computing in the promoted dtype of the features and
    the weights.

    ``A X`` (:meth:`propagate`) takes the CSR kernel
    (:func:`~tgp_tpu_torch.ops.kernels.segment_spmm.spmm_csr`) on a batch
    with the collator's CSR layout where ``use_kernel`` says so (``None``:
    the regime map :func:`~tgp_tpu_torch.ops.sparse.use_kernel_spmm`;
    ``True`` forces it, the kernel's plain version on CPU tensors), with
    the node mask folded into ``x``; else gather + segment-sum with both
    endpoints masked on a masked pooled graph.

    ``aggr="mean"`` divides by the degree counted over exactly the edges
    the sum adds (the same propagation of a column of ones, clamped at
    1).  ``tgp_tpu``'s degree sums every edge's weight, masks ignored; the
    two agree wherever every edge of the sum is valid (compact batches)."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggr: str = "add", *, use_kernel: Optional[bool] = None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggr not in ("add", "mean"):
            raise ValueError(f"aggr must be add|mean, got {aggr!r}")
        self.aggr = aggr
        self.use_kernel = use_kernel
        self.lin = lecun_normal_linear(in_channels, out_channels,
                                       generator=generator)
        self.lin_1 = lecun_normal_linear(in_channels, out_channels,
                                         bias=False, generator=generator)
        self.to(resolve_device(device))

    def forward(self, batch: GraphBatch, x: Optional[Tensor] = None
                ) -> Tensor:
        if x is None:
            x = batch.x
        root = apply_linear(self.lin, x)
        neigh = self.propagate(batch, x)
        if self.aggr == "mean":
            ones = torch.ones(batch.num_nodes, 1, dtype=x.dtype,
                              device=x.device)
            neigh = neigh / torch.clamp(self.propagate(batch, ones), min=1.0)
        out = root + apply_linear(self.lin_1, neigh)
        return torch.where(batch.node_mask[:, None], out, 0.0)

    def propagate(self, batch: GraphBatch, x: Tensor) -> Tensor:
        """``A X`` over the valid edges (and, on a masked pooled graph, the
        kept nodes), ``[N, F]`` in ``x``'s dtype."""
        want = self.use_kernel
        if want is None:
            want = use_kernel_spmm(batch.num_edges, batch.edges_sorted,
                                   x.device)
        w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)
        if want and batch.edges_sorted and batch.row_ptr is not None:
            from tgp_tpu_torch.ops.kernels.segment_spmm import spmm_csr

            # masked senders add nothing; gradients stay exact because the
            # mask scales x, not the edge list
            nm = batch.node_mask[:, None].to(x.dtype)
            w_t = (None if batch.edge_weight_t is None
                   else batch.edge_weight_t.to(torch.float32))
            return spmm_csr((x * nm).contiguous(), w.to(torch.float32), w_t,
                            batch.senders, batch.receivers, batch.row_ptr,
                            batch.receivers_t, batch.senders_t,
                            batch.row_ptr_t, batch.num_nodes)
        if batch.node_mask_shrunk:
            nm = batch.node_mask
            w = w * (nm[batch.senders.long()] & nm[batch.receivers.long()])
        return spmm(batch.senders, batch.receivers, w, x,
                    batch.num_nodes, indices_are_sorted=batch.edges_sorted)
