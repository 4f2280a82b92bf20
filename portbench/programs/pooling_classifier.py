"""The port's sparse ``PoolingClassifier`` (GCN → pooler → GCN →
readout → head), as the configuration states it."""

from __future__ import annotations

import numpy as np
import torch

#: the port's parameter names → the reference's
PARAMS = {"pre_convs.0.lin.weight": "W1", "pre_convs.0.bias": "b1",
          "pooler.selector.weight": "p", "post_convs.0.lin.weight": "W2",
          "post_convs.0.bias": "b2", "dense_0.weight": "D0",
          "dense_0.bias": "d0", "dense_1.weight": "D1", "dense_1.bias": "d1"}


def build(cfg: dict, device):
    from tgp_tpu_torch import PoolingClassifier, get_pooler

    pooler = get_pooler(cfg["pooler"], in_channels=cfg["hidden"],
                        ratio=cfg["ratio"], device=device)
    return PoolingClassifier(
        pooler, num_classes=cfg["num_classes"], hidden=cfg["hidden"],
        in_channels=cfg["in_channels"], readout=cfg["readout"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]), device=device)


def forward(model, batch):
    """Logits and the nodes the pooler kept (over the batch's nodes)."""
    logits, out = model(batch)
    return logits, out.so.node_sel_mask


def prepare(graphs, cfg: dict, traffic: dict, device):
    """A training batch, collated once."""
    from tgp_tpu_torch import from_graphs

    return from_graphs(graphs, sort_edges=traffic["sort_edges"],
                       device=device)


def predictor(apply_fn, traffic: dict, device):
    from tgp_tpu_torch import Predictor

    return Predictor(apply_fn, batch_size=traffic["batch_size"],
                     sort_edges=traffic["sort_edges"], device=device)


def bucket(graphs_sizes: list, predictor) -> tuple:
    """The bucket of ``predictor`` that a request of these ``(nodes,
    edges)`` sizes lands in, by the predictor's own bases."""
    from tgp_tpu_torch.models.inference import geometric_budget

    ns = [n for n, _ in graphs_sizes]
    es = [e for _, e in graphs_sizes]
    return (geometric_budget(sum(ns), predictor.node_base),
            geometric_budget(max(sum(es), 1), predictor.edge_base),
            geometric_budget(max(ns), predictor.node_base))


def buckets_served(predictor) -> int:
    """Distinct buckets the predictor has served so far."""
    return predictor.num_compiled


def shape(graphs, keep) -> dict:
    """Sizes the work counts read: real nodes and edges, and the pooled
    graph's kept nodes and non-loop edges between kept nodes."""
    keep = np.asarray(keep)
    n = sum(g[0].shape[0] for g in graphs)
    offs = np.cumsum([0] + [g[0].shape[0] for g in graphs])
    ei = np.concatenate([g[1] + o for g, o in zip(graphs, offs)], axis=1)
    k = keep[:n]
    kept_edges = int((k[ei[0]] & k[ei[1]] & (ei[0] != ei[1])).sum())
    return dict(nodes=n, edges=ei.shape[1], kept_nodes=int(k.sum()),
                kept_edges=kept_edges, graphs=len(graphs))
