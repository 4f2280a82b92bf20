"""Plain reference of the sparse top-k graph classifier: GCN → top-k
pooling → GCN → readout → two-layer head, over a list of graphs.

* GCN (Kipf & Welling): ``X' = D^{-1/2}(A+I)D^{-1/2} X W + b`` with
  messages from sender to receiver, the degree summed over each node's
  incoming edges, repeated edges counted each time, and a unit self-loop
  added only to a node that has no loop edge of its own.
* Top-k (Gao & Ji): ``score = tanh(x·p / ‖p‖)``; each graph keeps its
  ``ceil(ratio·n)`` best nodes (ties to the lower index); kept features are
  multiplied by their score; the pooled graph is the kept nodes' subgraph
  without loop edges.
* Readout (the configuration's ``readout``): the mean of each graph's
  kept nodes after the second GCN's ReLU; head:
  ``relu(z D0ᵀ + d0) D1ᵀ + d1``.

Float32 throughout, TF32 off.  ``quant`` rounds the GCN layers' operands,
where the configuration computes in its compute dtype (the control).
The selection may be given (``keep``): the reference then judges it by
its own scores and pools by it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.plain import precision

__all__ = ["param_shapes", "Packed", "pack", "forward", "work"]


def param_shapes(cfg: dict) -> dict:
    """Each parameter's shape and the std it is drawn with."""
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    return {"W1": ((h, f), 1 / math.sqrt(f)), "b1": ((h,), 0.1),
            "p": ((h,), 1 / math.sqrt(h)),
            "W2": ((h, h), 1 / math.sqrt(h)), "b2": ((h,), 0.1),
            "D0": ((h, h), 1 / math.sqrt(h)), "d0": ((h,), 0.1),
            "D1": ((c, h), 1 / math.sqrt(h)), "d1": ((c,), 0.1)}


class Packed:
    """Graphs laid end to end on one device: features, edges with node ids
    offset per graph, each node's graph."""

    def __init__(self, graphs, device):
        ns = [g[0].shape[0] for g in graphs]
        offs = np.concatenate([[0], np.cumsum(ns)])
        self.n = int(offs[-1])
        self.num_graphs = len(graphs)
        self.counts = torch.tensor(ns, device=device)
        self.x = torch.from_numpy(np.concatenate([g[0] for g in graphs])).to(
            device, torch.float32)
        ei = np.concatenate([g[1] + o for g, o in zip(graphs, offs)], axis=1)
        self.s = torch.from_numpy(ei[0]).to(device)
        self.r = torch.from_numpy(ei[1]).to(device)
        self.graph = torch.repeat_interleave(
            torch.arange(len(graphs), device=device), self.counts)


def pack(graphs, device) -> Packed:
    return Packed(graphs, device)


def _gcn(x, s, r, n, W, b, q):
    h = q(q(x) @ q(W).T)
    loop = s == r
    has_loop = torch.zeros(n, dtype=torch.bool, device=x.device)
    has_loop[s[loop]] = True
    unit = (~has_loop).to(torch.float32)
    deg = torch.zeros(n, device=x.device).index_add_(
        0, r, torch.ones(s.shape[0], device=x.device)) + unit
    dinv = deg.rsqrt()
    msg = h[s] * (dinv[s] * dinv[r])[:, None]
    out = torch.zeros_like(h).index_add(0, r, msg)
    return q(out + h * (unit * dinv * dinv)[:, None]) + b


def _rank(score, graph):
    """Rank of each node within its graph by descending score, ties to
    the lower index."""
    order = torch.sort(-score, stable=True).indices
    order = order[torch.sort(graph[order], stable=True).indices]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=order.device)
    start = torch.cumsum(torch.bincount(graph), 0) - torch.bincount(graph)
    return pos - start[graph]


def forward(params: dict, g: Packed, cfg: dict, keep=None, quant=None):
    """Logits ``[graphs, classes]`` and what the selection was: ``keep``
    (the nodes pooled) and ``gap``, the widest amount by which, in one
    graph, a kept node's score lies below a dropped one's (0 where the
    selection is a top-k of these scores), or inf where a graph keeps the
    wrong number of nodes."""
    q = precision(quant)
    x1 = F.relu(_gcn(g.x, g.s, g.r, g.n, params["W1"], params["b1"], q))
    p = params["p"]
    score = torch.tanh(x1 @ p / p.norm())
    k = torch.ceil(cfg["ratio"] * g.counts.to(torch.float32)).long()
    if keep is None:
        keep = _rank(score.detach(), g.graph) < k[g.graph]
    keep = keep.to(device=score.device, dtype=torch.bool)
    B = g.num_graphs
    sd = score.detach()
    neg, pos = torch.full((B,), -math.inf, device=sd.device), torch.full(
        (B,), math.inf, device=sd.device)
    top_dropped = neg.scatter_reduce(0, g.graph[~keep], sd[~keep], "amax")
    low_kept = pos.scatter_reduce(0, g.graph[keep], sd[keep], "amin")
    gap = torch.clamp(top_dropped - low_kept, min=0).nan_to_num(0.0)
    kept = torch.bincount(g.graph[keep], minlength=B)
    gap = float(gap.max()) if bool((kept == k).all()) else math.inf

    idx = torch.nonzero(keep).squeeze(1)
    new_id = torch.full((g.n,), -1, dtype=torch.long, device=sd.device)
    new_id[idx] = torch.arange(idx.shape[0], device=sd.device)
    e = keep[g.s] & keep[g.r] & (g.s != g.r)
    x2 = x1[idx] * score[idx][:, None]
    h2 = F.relu(_gcn(x2, new_id[g.s[e]], new_id[g.r[e]], idx.shape[0],
                     params["W2"], params["b2"], q))
    z = torch.zeros(B, h2.shape[1], device=h2.device).index_add(
        0, g.graph[idx], h2)
    z = _readout(z, kept, cfg)
    z = F.relu(z @ params["D0"].T + params["d0"])
    return z @ params["D1"].T + params["d1"], dict(keep=keep, gap=gap)


def _readout(total, count, cfg: dict):
    """The graph's vector from the sum over its ``count`` kept nodes: their
    mean, the configuration's readout."""
    if cfg["readout"] != "mean":
        raise ValueError(f"readout {cfg['readout']!r} is not in the reference")
    return total / count.clamp_min(1).to(total.dtype)[:, None]


def work(cfg: dict, shape: dict, train: bool, count) -> dict:
    """Operations and bytes of one request or step, from its shapes:
    ``shape`` has ``nodes``, ``edges`` (real edges), ``kept_nodes``,
    ``kept_edges`` (the pooled graph's, loops dropped) and ``graphs``.
    ``count`` is :mod:`portbench.harness.counting`.  Returns the kernel
    operations (``ops``: name, flops, bytes, peak) and the whole
    request's or step's compulsory ``flops`` and ``bytes``."""
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    n, e = shape["nodes"], shape["edges"]
    nk, ek, b = shape["kept_nodes"], shape["kept_edges"], shape["graphs"]
    bf = count.itemsize(cfg["compute_dtype"])
    ops = [count.spmm("spmm_csr", n, e, h, bf),        # layer 1's A·XW
           count.spmm("spmm_csr", nk, ek, 1, 4),       # pooled degree
           count.spmm("spmm_csr", nk, ek, h, bf)]      # layer 2's A·XW
    if train:  # the transposed products of both layers' input gradients
        ops += [count.spmm("spmm_csr", nk, ek, h, bf),
                count.spmm("spmm_csr", n, e, h, bf)]
    dense = [(n, f, h, False), (nk, h, h, True), (b, h, h, True),
             (b, h, c, True)]  # (rows, in, out, input needs a gradient)
    flops = sum(count.matmul_flops(m, i, o, train, needs)
                for m, i, o, needs in dense)
    flops += sum(op["flops"] for op in ops)
    flops += 2 * n * h  # scores
    inputs = n * f * 4 + e * 3 * 4  # features; senders, receivers, weights
    params = h * f + 3 * h * h + c * h + 4 * h + c
    state = params * 4 * (4 if train else 1)  # + gradient and Adam moments
    nbytes = inputs * (2 if train else 1) + state + b * c * 4
    return dict(ops=ops, flops=flops, bytes=nbytes)
