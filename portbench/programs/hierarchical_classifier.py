"""The port's ``HierarchicalClassifier`` (SAGPool_h: a block of GCN →
SAG pool → max‖mean readout for each of ``num_blocks`` levels, the
readouts summed, an MLP head), as the configuration states it."""

from __future__ import annotations

import numpy as np
import torch


def _names(blocks: int, layers: int) -> dict:
    out = {}
    for l in range(blocks):
        out.update({f"convs.{l}.lin.weight": f"W{l}",
                    f"convs.{l}.bias": f"b{l}",
                    f"poolers.{l}.gnn.lin.weight": f"t{l}",
                    f"poolers.{l}.gnn.bias": f"u{l}"})
    for j in range(layers):
        out.update({f"head.{j}.weight": f"D{j}", f"head.{j}.bias": f"d{j}"})
    return out


#: the port's parameter names → the reference's (3 blocks, 3 head layers)
PARAMS = _names(3, 3)


def build(cfg: dict, device):
    from tgp_tpu_torch import HierarchicalClassifier, get_pooler

    poolers = [get_pooler(cfg["pooler"], in_channels=cfg["hidden"],
                          ratio=cfg["ratio"], gnn_kind=cfg["gnn_kind"],
                          nonlinearity=cfg["nonlinearity"],
                          multiplier=cfg["multiplier"], device=device)
               for _ in range(cfg["num_blocks"])]
    return HierarchicalClassifier(
        poolers, num_classes=cfg["num_classes"], hidden=cfg["hidden"],
        in_channels=cfg["in_channels"], readout=cfg["readout"],
        head=tuple(cfg["head"]),
        compute_dtype=getattr(torch, cfg["compute_dtype"]), device=device)


def kept(outs, num_nodes: int) -> torch.Tensor:
    """Each level's kept input nodes, bool ``[levels, num_nodes]`` over
    the batch's node slots: a compact level's selection is over its input
    graph's ``B·Kmax`` slots, which each node's ``cluster_index`` at the
    levels before maps it to; a masked level keeps the node space."""
    slot = torch.arange(num_nodes, device=outs[0].so.node_sel_mask.device)
    keep, rows = None, []
    for out in outs:
        sel = out.so.node_sel_mask[slot]
        keep = sel if keep is None else keep & sel
        rows.append(keep)
        if out.so.extras.get("pool_mode") != "masked":
            slot = out.so.cluster_index.long()[slot]
    return torch.stack(rows)


def forward(model, batch):
    """Logits and each level's kept nodes (:func:`kept`)."""
    logits, outs = model(batch)
    return logits, kept(outs, batch.num_nodes)


def prepare(graphs, cfg: dict, traffic: dict, device):
    """A training batch, collated once."""
    from tgp_tpu_torch import from_graphs

    return from_graphs(graphs, sort_edges=traffic["sort_edges"],
                       device=device)


def shape(graphs, keep) -> dict:
    """Sizes the work counts read: the graphs, the real nodes entering
    each block and the last block's kept nodes, and the real edges of
    each block's graph (after the first, those between kept nodes that
    are not loops)."""
    keep = np.asarray(keep)
    n = sum(g[0].shape[0] for g in graphs)
    offs = np.cumsum([0] + [g[0].shape[0] for g in graphs])
    ei = np.concatenate([g[1] + o for g, o in zip(graphs, offs)], axis=1)
    keep, loop = keep[:, :n], ei[0] == ei[1]
    nodes = [n] + [int(k.sum()) for k in keep]
    edges = [ei.shape[1]] + [int((k[ei[0]] & k[ei[1]] & ~loop).sum())
                             for k in keep[:-1]]
    return dict(graphs=len(graphs), nodes=nodes, edges=edges)
