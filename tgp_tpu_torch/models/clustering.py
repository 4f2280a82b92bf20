"""Transductive node clustering (port of ``tgp_tpu/models/clustering.py``):
message-passing layers → dense pooler; the soft assignment ``S`` is the
clustering, scored by NMI against the ground-truth communities."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.mp.gtvconv import GTVConv
from tgp_tpu_torch.src import PoolingOutput

__all__ = ["ClusteringModel", "nmi_score"]


class ClusteringModel(nn.Module):
    """``num_mp_layers`` of ``GCNConv`` + ReLU (``mp_type="gcn"``) or
    ``GTVConv`` with ELU (``"gtv"``, TVGNN's layer, ``delta_coeff``), then
    the pooler; ``forward`` returns ``(s, PoolingOutput)``.  The layers
    are the modules ``conv``, ``conv_1``, … (flax's ``GCNConv_<i>`` or
    ``GTVConv_<i>``, :func:`~tgp_tpu_torch.models.convert.
    params_from_flax`); ``in_channels`` is the input width (default
    ``hidden``)."""

    def __init__(self, pooler: nn.Module, hidden: int = 32,
                 num_mp_layers: int = 2, mp_type: str = "gcn",
                 delta_coeff: float = 0.311,
                 in_channels: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mp_type not in ("gcn", "gtv"):
            raise ValueError(f"mp_type must be gcn|gtv, got {mp_type!r}")
        device = resolve_device(device)
        self.hidden = hidden
        self.num_mp_layers = num_mp_layers
        self.mp_type = mp_type
        self.delta_coeff = delta_coeff
        width = hidden if in_channels is None else in_channels
        for i in range(num_mp_layers):
            if mp_type == "gtv":
                conv = GTVConv(width, hidden, delta_coeff=delta_coeff,
                               act="elu", device=device, generator=generator)
            else:
                conv = GCNConv(width, hidden, device=device,
                               generator=generator)
            self.add_module("conv" if i == 0 else f"conv_{i}", conv)
            width = hidden
        self.pooler = pooler
        self.to(device)

    @property
    def convs(self):
        return [getattr(self, "conv" if i == 0 else f"conv_{i}")
                for i in range(self.num_mp_layers)]

    def forward(self, batch: GraphBatch
                ) -> Tuple[torch.Tensor, PoolingOutput]:
        h = batch.x
        for conv in self.convs:
            h = conv(batch, h)
            if self.mp_type == "gcn":
                h = F.relu(h)
        out = self.pooler(batch.with_features(h))
        return out.so.s, out


def _entropy(counts: np.ndarray) -> float:
    """Entropy (nats) of a labelling from its nonzero class counts."""
    if counts.size == 1:
        return 0.0
    pi = counts.astype(np.float64)
    total = np.sum(pi)
    return float(-np.sum((pi / total) * (np.log(pi) - np.log(total))))


def nmi_score(labels_true, labels_pred) -> float:
    """Normalized mutual information with the arithmetic-mean normalizer,
    in numpy: scikit-learn's ``normalized_mutual_info_score`` (its
    default ``average_method="arithmetic"``), step for step.  Both
    labellings with one cluster, or none, score 1.0."""
    labels_true = np.asarray(labels_true).reshape(-1)
    labels_pred = np.asarray(labels_pred).reshape(-1)
    if labels_true.shape != labels_pred.shape:
        raise ValueError(f"labellings differ in length: {labels_true.shape} "
                         f"vs {labels_pred.shape}")
    classes, ci, ca = np.unique(labels_true, return_inverse=True,
                                return_counts=True)
    clusters, ki, ka = np.unique(labels_pred, return_inverse=True,
                                 return_counts=True)
    if (classes.shape[0] == clusters.shape[0] == 1
            or classes.shape[0] == clusters.shape[0] == 0):
        return 1.0
    # the contingency table, its nonzeros in row-major order
    table = np.zeros((classes.shape[0], clusters.shape[0]), np.float64)
    np.add.at(table, (ci.reshape(-1), ki.reshape(-1)), 1.0)
    nzx, nzy = np.nonzero(table)
    nz_val = table[nzx, nzy]
    total = table.sum()
    pi, pj = table.sum(axis=1), table.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        mi = 0.0
    else:
        log_nm = np.log(nz_val)
        nm = nz_val / total
        outer = (pi.take(nzx).astype(np.int64)
                 * pj.take(nzy).astype(np.int64))
        log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
        terms = nm * (log_nm - np.log(total)) + nm * log_outer
        terms = np.where(np.abs(terms) < np.finfo(terms.dtype).eps, 0.0,
                         terms)
        mi = float(np.clip(terms.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    normalizer = np.mean([_entropy(ca), _entropy(ka)])
    return float(mi / normalizer)
