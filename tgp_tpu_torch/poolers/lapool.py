"""LaPooling (port of ``tgp_tpu/poolers/lapool.py``; Noutahi et al.
2019): :func:`~tgp_tpu_torch.select.lapool.lapool_select`'s unbatched
``S [N, Kmax]``, ``SᵀX`` and ``SᵀAS`` per graph, and the dense pooled
graph ``[B, Kmax, ·]`` post-processed (degree-normalized by default).  No
parameters.

The port's choice: ``ACCEPTS_DENSE_BATCH`` is False, so ``prepare_batch``
keeps the batch sparse — the selection reads the sparse edge list.  JAX's
``LaPooling`` inherits True from ``DenseSRCPooling`` and fails on the
dense batch ``prepare_batch`` then hands it.
"""

from __future__ import annotations

from typing import Optional

import torch

from tgp_tpu_torch.connect.base import dense_connect_unbatched
from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch
from tgp_tpu_torch.ops.sparse import postprocess_adj_dense
from tgp_tpu_torch.reduce.base import reduce_dense_unbatched
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.lapool import lapool_select, shortest_path_weights
from tgp_tpu_torch.src import DenseSRCPooling, PoolingOutput

__all__ = ["LaPooling"]


class LaPooling(DenseSRCPooling):
    """``"lap"``.  ``shortest_path_reg`` runs the selection twice, with the
    host's shortest-path weights the second time; ``sparse_output``
    returns the pooled graph as a block-diagonal sparse batch."""

    IS_TRAINABLE = False
    ACCEPTS_DENSE_BATCH = False

    def __init__(self, shortest_path_reg: bool = False,
                 remove_self_loops: bool = True, degree_norm: bool = True,
                 edge_weight_norm: bool = False, s_inv_op: str = "transpose",
                 sparse_output: bool = False, lift_op: str = "precomputed",
                 lift_red_op: str = "sum"):
        super().__init__(lift_op=lift_op, lift_red_op=lift_red_op)
        self.shortest_path_reg = shortest_path_reg
        self.remove_self_loops = remove_self_loops
        self.degree_norm = degree_norm
        self.edge_weight_norm = edge_weight_norm
        self.s_inv_op = s_inv_op
        self.sparse_output = sparse_output

    def forward(self, batch: GraphBatch, *, so: Optional[SelectOutput] = None,
                lifting: bool = False, x: Optional[torch.Tensor] = None):
        if lifting:
            return self.lift(x if x is not None else batch.x, so)
        if so is None:
            so = lapool_select(batch, s_inv_op=self.s_inv_op)
            if self.shortest_path_reg:
                spw = shortest_path_weights(batch, so.extras["leader"],
                                            so.extras["slot"])
                so = lapool_select(batch, shortest_path_reg=True,
                                   sp_weight=spw, s_inv_op=self.s_inv_op)
        place = dict(node_pos=batch.node_pos, max_nodes=batch.max_nodes)
        x_pool = reduce_dense_unbatched(batch.x, so.s, batch.node_graph,
                                        batch.num_graphs, batch.node_mask,
                                        **place)
        adj = dense_connect_unbatched(
            batch.senders, batch.receivers, batch.edge_weight, so.s,
            batch.node_graph, batch.num_graphs, batch.node_mask, **place)
        adj = postprocess_adj_dense(
            adj, remove_self_loops_flag=self.remove_self_loops,
            degree_norm=self.degree_norm,
            edge_weight_norm=self.edge_weight_norm)
        out = DenseGraphBatch(x=x_pool, adj=adj, mask=so.out_mask())
        if self.sparse_output:
            return PoolingOutput(so=so,
                                 graph=self.finalize_sparse_output(out))
        return PoolingOutput(so=so, dense=out)
