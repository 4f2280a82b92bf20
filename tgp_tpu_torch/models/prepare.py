"""Model-level regime dispatch (port of ``tgp_tpu/models/prepare.py``):
route a batch of small graphs to the dense pipeline, once per batch, on
the way into the step function.

    pooler = get_pooler("topk", in_channels=128)
    batch = prepare_batch(from_graphs(graphs), pooler=pooler, normalize=True)
    model = PoolingClassifier(pooler, ..., pre_normalized=isinstance(
        batch, DenseGraphBatch))
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tgp_tpu_torch.graph import DenseGraphBatch, GraphBatch, to_dense
from tgp_tpu_torch.mp.gcn import gcn_norm_dense
from tgp_tpu_torch.ops.sparse import use_dense_pipeline

__all__ = ["prepare_batch"]


def prepare_batch(batch: Union[GraphBatch, DenseGraphBatch], *,
                  densify: Union[str, bool] = "auto", normalize: bool = False,
                  adj_dtype: Optional[torch.dtype] = torch.bfloat16,
                  pooler=None) -> Union[GraphBatch, DenseGraphBatch]:
    """Densify ``batch`` where the regime map says the dense pipeline
    wins; otherwise return it unchanged.  The result stays on the batch's
    device.

    ``densify``: ``"auto"`` applies :func:`~tgp_tpu_torch.ops.sparse.
    use_dense_pipeline` to ``(num_graphs, max_nodes)``, and only for a
    ``pooler`` (instance or class) whose ``ACCEPTS_DENSE_BATCH`` is set
    (an unbatched ``batched=False`` instance cannot take one); without a
    pooler, auto never densifies.  ``True``/``False`` force; forcing for a
    pooler that cannot take a dense batch raises, as does handing it one.
    ``normalize``: apply :func:`~tgp_tpu_torch.mp.gcn.gcn_norm_dense` once
    (pair with ``pre_normalized=True``), casting the normalized adjacency
    to ``adj_dtype`` (``None`` keeps f32)."""
    if pooler is not None:
        cls = pooler if isinstance(pooler, type) else type(pooler)
        dense_ok = bool(getattr(cls, "ACCEPTS_DENSE_BATCH", False))
        if not isinstance(pooler, type):
            dense_ok = dense_ok and getattr(pooler, "batched", True)
    else:
        cls = None
        dense_ok = True  # an explicit densify=True is an informed override
    if isinstance(batch, DenseGraphBatch):
        if not dense_ok:
            raise ValueError(
                f"{cls.__name__} cannot consume a DenseGraphBatch "
                "(ACCEPTS_DENSE_BATCH is False) — collate a sparse "
                "GraphBatch instead")
        dense = batch
    else:
        if densify == "auto":
            go = (pooler is not None and dense_ok
                  and use_dense_pipeline(batch.num_graphs, batch.max_nodes))
        else:
            go = bool(densify)
            if go and not dense_ok:
                raise ValueError(
                    f"densify=True but {cls.__name__} cannot consume a "
                    "DenseGraphBatch (ACCEPTS_DENSE_BATCH is False)")
        if not go:
            return batch
        dense = to_dense(batch)
    if normalize:
        dense = gcn_norm_dense(dense, adj_dtype=adj_dtype)
    return dense
