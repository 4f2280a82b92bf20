"""The port's ``DenseTopkClassifier`` on a dense batch prepared once:
collated, densified and GCN-normalized in the compute dtype."""

from __future__ import annotations

import torch

PARAMS = {"pre_convs.0.lin.weight": "W1", "pre_convs.0.bias": "b1",
          "p": "p", "post_convs.0.lin.weight": "W2",
          "post_convs.0.bias": "b2", "dense_0.weight": "D0",
          "dense_0.bias": "d0", "dense_1.weight": "D1", "dense_1.bias": "d1"}


def build(cfg: dict, device):
    from tgp_tpu_torch import DenseTopkClassifier

    return DenseTopkClassifier(
        num_classes=cfg["num_classes"], hidden=cfg["hidden"],
        ratio=cfg["ratio"], readout=cfg["readout"], pre_normalized=True,
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        use_kernel=cfg["use_kernel"], in_channels=cfg["in_channels"],
        device=device)


def forward(model, batch):
    """Logits and the pooled features ``[B, k, F]``: the model returns no
    selection, and the reference finds it from them."""
    logits, pooled = model(batch)
    return logits, pooled.x


def prepare(graphs, cfg: dict, traffic: dict, device):
    from tgp_tpu_torch import from_graphs, gcn_norm_dense, to_dense

    dense = to_dense(from_graphs(graphs, device=device))
    return gcn_norm_dense(dense, adj_dtype=getattr(torch, cfg["compute_dtype"]))


def shape(graphs, keep) -> dict:
    return dict(graphs=len(graphs), nodes=graphs[0][0].shape[0])
