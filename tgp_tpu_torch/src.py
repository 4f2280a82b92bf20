"""SRC(L) core (port of ``tgp_tpu/src.py``: ``PoolingOutput``,
``SRCPooling``, ``DenseSRCPooling`` and ``PrecoarseningMixin``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from tgp_tpu_torch.connect.base import (ConnectConfig, PooledEdges,
                                       sparse_connect)
from tgp_tpu_torch.graph import (DenseGraphBatch, GraphBatch, from_dense,
                                 to_dense)
from tgp_tpu_torch.lift.base import base_lift
from tgp_tpu_torch.reduce.base import base_reduce
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["PoolingOutput", "SRCPooling", "DenseSRCPooling",
           "PrecoarseningMixin"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class PoolingOutput:
    """Result of one pooling step: the selection, the pooled sparse or
    dense batch and the named auxiliary losses."""

    so: SelectOutput
    graph: Optional[GraphBatch] = None
    dense: Optional[DenseGraphBatch] = None
    loss: Dict[str, Tensor] = field(default_factory=dict)

    @property
    def x(self) -> Tensor:
        return self.graph.x if self.graph is not None else self.dense.x

    @property
    def mask(self) -> Tensor:
        """Pooled-node validity."""
        return (self.graph.node_mask if self.graph is not None
                else self.dense.mask)

    def loss_sum(self) -> Tensor:
        """Σ of the auxiliary losses (added to the task loss in training);
        a 0-d zero on the pooled features' device when there are none."""
        if not self.loss:
            return torch.zeros((), device=self.x.device)
        return sum(self.loss.values())


class SRCPooling(nn.Module):
    """Base class for sparse-world poolers: the shared Reduce / Connect /
    Lift plumbing.  ``lift_op``/``lift_red_op`` configure the lift.

    Capability flags are plain class attributes, which a subclass
    overrides with a bare assignment (JAX's values, read by the
    cheatsheet): ``IS_DENSE``, ``HAS_LOSS`` (auxiliary losses),
    ``IS_TRAINABLE``, ``IS_PRECOARSENABLE`` (a feature-independent
    selection that can run offline), ``SUPPORTS_SPARSE_OUT``,
    ``ACCEPTS_DENSE_BATCH``: the pooler's ``forward`` takes a
    :class:`DenseGraphBatch` (the gate of ``prepare_batch``), and
    ``CAPTURABLE``: its forward of a sparse batch reads nothing back to
    the host, so a CUDA graph can capture it (the gate of
    :class:`~tgp_tpu_torch.models.classifiers.PoolingClassifier`'s
    replay)."""

    IS_DENSE = False
    HAS_LOSS = False
    IS_TRAINABLE = False
    IS_PRECOARSENABLE = False
    SUPPORTS_SPARSE_OUT = True
    ACCEPTS_DENSE_BATCH = False
    CAPTURABLE = False

    def __init__(self, lift_op: str = "precomputed",
                 lift_red_op: str = "sum"):
        super().__init__()
        self.lift_op = lift_op
        self.lift_red_op = lift_red_op

    def reduce(self, x: Tensor, so: SelectOutput) -> Tensor:
        return base_reduce(x, so)

    def lift(self, x_pool: Tensor, so: SelectOutput) -> Tensor:
        return base_lift(x_pool, so, matrix_op=self.lift_op,
                         reduce_op=self.lift_red_op)

    def connect(self, batch: GraphBatch, so: SelectOutput,
                cfg: ConnectConfig = ConnectConfig()):
        return sparse_connect(batch.senders, batch.receivers,
                              batch.edge_weight, batch.edge_mask, so, cfg)

    def pooled_graph(self, x_pool: Tensor, edges: PooledEdges,
                     so: SelectOutput, batch: GraphBatch) -> GraphBatch:
        """Assemble the pooled :class:`GraphBatch` from reduce + connect
        (``edges_sorted`` as the connect laid the edges out)."""
        out_mask = so.out_mask()
        return GraphBatch(
            x=torch.where(out_mask[:, None], x_pool, 0.0),
            senders=edges.senders,
            receivers=edges.receivers,
            edge_weight=edges.edge_weight,
            edge_mask=edges.edge_mask,
            node_graph=so.cluster_graph,
            node_pos=so.cluster_pos,
            node_mask=out_mask,
            num_graphs=batch.num_graphs,
            max_nodes=so.max_clusters,
            edges_sorted=edges.edges_sorted,
        )


class DenseSRCPooling(SRCPooling):
    """Base for dense-world poolers: they take a sparse
    :class:`GraphBatch` and densify it (:meth:`ensure_dense`), or a
    pre-densified :class:`DenseGraphBatch`; ``sparse_output`` poolers hand
    their dense pooled graph back as a block-diagonal sparse batch
    (:meth:`finalize_sparse_output`)."""

    IS_DENSE = True
    ACCEPTS_DENSE_BATCH = True

    @staticmethod
    def ensure_dense(batch, adj_transpose: bool = False) -> DenseGraphBatch:
        """A dense batch as it is; a sparse one through
        :func:`~tgp_tpu_torch.graph.to_dense`, its adjacency transposed
        with ``adj_transpose``."""
        if isinstance(batch, DenseGraphBatch):
            return batch
        dense = to_dense(batch)
        if adj_transpose:
            dense = dense.replace(adj=dense.adj.transpose(-1, -2))
        return dense

    @staticmethod
    def finalize_sparse_output(dense: DenseGraphBatch) -> GraphBatch:
        """Dense pooled ``[B, K, K]`` → block-diagonal sparse batch
        (invalid supernodes masked, not dropped)."""
        return from_dense(dense)


class PrecoarseningMixin:
    """Protocol of poolers whose selection is feature-independent and
    has no parameters, so it can run offline on the host (port of
    ``tgp_tpu.src.PrecoarseningMixin``): ``precoarsen_graph`` makes one
    level dict in numpy; :meth:`multi_level_precoarsen` rolls levels out
    greedily."""

    def precoarsen_graph(self, edge_index, num_nodes, edge_weight=None):
        raise NotImplementedError

    def multi_level_precoarsen(self, edge_index, num_nodes, edge_weight=None,
                               levels: int = 1):
        """Greedy rollout: each level's pooled graph feeds the next."""
        out = []
        for _ in range(levels):
            lvl = self.precoarsen_graph(edge_index, num_nodes, edge_weight)
            out.append(lvl)
            edge_index = lvl["edge_index"]
            edge_weight = lvl.get("edge_weight")
            num_nodes = lvl["num_clusters"]
        return out
