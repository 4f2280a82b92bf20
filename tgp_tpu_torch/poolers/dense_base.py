"""The shared forward of the dense soft-cluster poolers (port of
``tgp_tpu/poolers/dense_base.py``): MinCut, DiffPool, DMoN, HOSC,
JustBalance and AsymCheegerCut.

* batched: densify (:meth:`~tgp_tpu_torch.src.DenseSRCPooling.
  ensure_dense`) → select (``MLPSelect``, ``s [B, N, K]``) → reduce
  ``SᵀX`` → connect ``SᵀAS`` → :meth:`compute_loss` on the raw pooled
  adjacency → post-process;
* unbatched (``batched=False``, the ``"<alias>_u"`` aliases): select
  (``[N, K]``) → :meth:`compute_sparse_loss` → the per-graph products of
  the unbatched reduce and connect → post-process.

The two modes give the same losses, pooled features and pooled
adjacency.  ``SᵀX`` and ``SᵀAS`` are ``torch.matmul`` in f32 (the JAX
package's ``einsum``, no Pallas kernel); ``sparse_output`` hands the
pooled graph back as a block-diagonal sparse batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from tgp_tpu_torch._device import DeviceLike
from tgp_tpu_torch.connect.base import dense_connect, dense_connect_unbatched
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.reduce.base import (reduce_dense_batched,
                                       reduce_dense_unbatched)
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.mlp import MLPSelect
from tgp_tpu_torch.src import DenseSRCPooling, PoolingOutput

__all__ = ["DenseClusterPooling"]

Tensor = torch.Tensor


class DenseClusterPooling(DenseSRCPooling):
    """Base of the ``MLPSelect``-driven dense poolers.  A subclass takes
    its loss coefficients as keywords, passes the rest on (``**kw``), and
    defines the two loss hooks.  ``generator`` draws the selector's
    weights, ``dropout_generator`` its dropout."""

    def __init__(self, in_channels: Union[int, List[int], None] = None,
                 k: int = 8, act: Optional[str] = None, dropout: float = 0.0,
                 remove_self_loops: bool = True, degree_norm: bool = True,
                 edge_weight_norm: bool = False, adj_transpose: bool = False,
                 s_inv_op: str = "transpose", batched: bool = True,
                 sparse_output: bool = False, lift_op: str = "precomputed",
                 lift_red_op: str = "sum", *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.k = k
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.adj_transpose = adj_transpose
        self.batched = batched
        self.sparse_output = sparse_output
        self.selector = MLPSelect(in_channels, k, batched, act, dropout,
                                  s_inv_op, device=device,
                                  generator=generator,
                                  dropout_generator=dropout_generator)

    def compute_loss(self, dense: DenseGraphBatch, so: SelectOutput,
                     adj_pool: Tensor) -> Dict[str, Tensor]:
        return {}

    def compute_sparse_loss(self, batch: GraphBatch,
                            so: SelectOutput) -> Dict[str, Tensor]:
        return {}

    def _postprocess(self, adj: Tensor) -> Tensor:
        return postprocess_adj_dense(
            adj, remove_self_loops_flag=self.remove_self_loops,
            degree_norm=self.degree_norm,
            edge_weight_norm=self.edge_weight_norm,
            adj_transpose=self.adj_transpose)

    def forward(self, batch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if self.batched:
            dense = self.ensure_dense(batch, self.adj_transpose)
            if so is None:
                so = self.selector(dense)
            x_pool = reduce_dense_batched(dense.x, so.s)
            adj_raw = dense_connect(dense.adj, so.s)
            loss = self.compute_loss(dense, so, adj_raw)
        else:
            if not isinstance(batch, GraphBatch):
                raise TypeError("an unbatched dense pooler expects a flat "
                                "GraphBatch")
            if so is None:
                so = self.selector(batch)
            loss = self.compute_sparse_loss(batch, so)
            place = dict(node_pos=batch.node_pos, max_nodes=batch.max_nodes)
            x_pool = reduce_dense_unbatched(
                batch.x, so.s, batch.node_graph, batch.num_graphs,
                batch.node_mask, **place)
            adj_raw = dense_connect_unbatched(
                batch.senders, batch.receivers, batch.edge_weight, so.s,
                batch.node_graph, batch.num_graphs, batch.node_mask, **place)
        out = DenseGraphBatch(x=x_pool, adj=self._postprocess(adj_raw),
                              mask=so.out_mask())
        if self.sparse_output:
            return PoolingOutput(so=so, graph=self.finalize_sparse_output(out),
                                 loss=loss)
        return PoolingOutput(so=so, dense=out, loss=loss)
