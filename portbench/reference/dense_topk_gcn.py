"""Plain reference of the dense top-k graph classifier on a batch of
graphs of one size: GCN → top-k pooling → GCN → readout → two-layer
head, on ``[B, N, ...]`` tensors.

* The adjacency holds ``A[s, r]`` summed over repeated edges;
  ``Â = D^{-1/2}(A+I)D^{-1/2}`` with ``D`` the row sums of ``|A+I|``;
  a layer is ``Â (X Wᵀ) + b``.
* Top-k: ``score = tanh(x·p / ‖p‖)``; each graph keeps its
  ``ceil(ratio·n)`` best nodes (ties to the lower index), ordered by
  score; kept features are multiplied by their score.
* The pooled adjacency is ``Â`` restricted to the kept nodes, and the
  second layer normalizes it again with its own unit self-loops.
* Readout (the configuration's ``readout``): the mean over kept nodes
  after the second layer's ReLU; head: ``relu(z D0ᵀ + d0) D1ᵀ + d1``.

Float32 throughout, TF32 off; ``quant`` rounds the GCN layers'
operands (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.plain import precision

__all__ = ["param_shapes", "pack", "forward", "work"]


def param_shapes(cfg: dict) -> dict:
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    return {"W1": ((h, f), 1 / math.sqrt(f)), "b1": ((h,), 0.1),
            "p": ((h,), 1 / math.sqrt(h)),
            "W2": ((h, h), 1 / math.sqrt(h)), "b2": ((h,), 0.1),
            "D0": ((h, h), 1 / math.sqrt(h)), "d0": ((h,), 0.1),
            "D1": ((c, h), 1 / math.sqrt(h)), "d1": ((c,), 0.1)}


class Packed:
    """``x [B, N, F]`` and the raw adjacency ``[B, N, N]``."""

    def __init__(self, graphs, device):
        ns = {g[0].shape[0] for g in graphs}
        if len(ns) != 1:
            raise ValueError(f"graphs of one size expected, got {sorted(ns)}")
        n = ns.pop()
        B = len(graphs)
        self.x = torch.from_numpy(np.stack([g[0] for g in graphs])).to(
            device, torch.float32)
        self.adj = torch.zeros(B, n, n, device=device)
        for b, (_, ei) in enumerate(graphs):
            s = torch.from_numpy(ei[0]).to(device)
            r = torch.from_numpy(ei[1]).to(device)
            self.adj[b].index_put_((s, r), torch.ones(s.shape[0],
                                                      device=device),
                                   accumulate=True)
        self.num_graphs, self.n = B, n


def pack(graphs, device) -> Packed:
    return Packed(graphs, device)


def _norm(adj):
    eye = torch.eye(adj.shape[-1], device=adj.device)
    a = adj + eye
    dinv = a.abs().sum(-1).rsqrt()
    return dinv[..., :, None] * a * dinv[..., None, :]


def _matched(x1, pooled):
    """Which node of each graph each pooled row is.  A pooled row is a
    node's features times its score, and the scores at the boundary of
    the selection are near 0, so rows are matched by direction: the node
    whose features ``x1 [B, N, F]`` are most nearly parallel (or
    antiparallel) to the row of ``pooled [B, k, F]``."""
    xn = x1 / x1.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    pn = pooled.to(x1.dtype)
    pn = pn / pn.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    return (pn @ xn.transpose(1, 2)).abs().argmax(-1)


def forward(params: dict, g: Packed, cfg: dict, keep=None, quant=None):
    """Logits ``[B, classes]`` and the selection: ``keep``, the kept nodes
    ``[B, k]``, and ``gap``, the widest amount by which, in one graph, a
    kept node's score lies below a dropped one's (inf where a node is
    kept twice).  ``keep`` may be given as indices, or as the pooled
    features the port produced (``[B, k, F]``), each row matched to the
    node it was pooled from."""
    q = precision(quant)
    a1 = _norm(g.adj)
    h = q(g.x) @ q(params["W1"]).T
    x1 = F.relu(q(q(a1) @ q(h)) + params["b1"])
    p = params["p"]
    score = torch.tanh(x1 @ p / p.norm())
    k = max(int(math.ceil(cfg["ratio"] * g.n)), 1)
    sd = score.detach()
    if keep is None:
        idx = torch.sort(sd, dim=-1, descending=True, stable=True).indices[
            :, :k]
    elif keep.is_floating_point():
        idx = _matched(x1.detach(), keep)
    else:
        idx = keep.to(sd.device)
    kept = torch.zeros_like(sd, dtype=torch.bool).scatter_(1, idx, True)
    gap = torch.clamp(torch.where(kept, -math.inf, sd).amax(-1)
                      - torch.where(kept, sd, math.inf).amin(-1), min=0)
    unique = idx.shape[1] == k and bool((kept.sum(-1) == k).all())
    gap = float(gap.max()) if unique else math.inf
    gate = torch.gather(score, 1, idx)
    x2 = torch.gather(x1, 1, idx[..., None].expand(-1, -1, x1.shape[2]))
    x2 = x2 * gate[..., None]
    a2 = torch.gather(a1, 1, idx[..., None].expand(-1, -1, g.n))
    a2 = _norm(torch.gather(a2, 2, idx[:, None, :].expand(-1, k, -1)))
    h2 = q(x2) @ q(params["W2"]).T
    x3 = F.relu(q(q(a2) @ q(h2)) + params["b2"])
    if cfg["readout"] != "mean":
        raise ValueError(f"readout {cfg['readout']!r} is not in the "
                         "reference")
    z = F.relu(x3.mean(1) @ params["D0"].T + params["d0"])
    return z @ params["D1"].T + params["d1"], dict(keep=idx, gap=gap)


def work(cfg: dict, shape: dict, train: bool, count) -> dict:
    """``shape``: ``graphs`` (B) and ``nodes`` (N per graph).  The kernel
    operations are the adjacency products (``dense_bmm``): bf16 operands,
    f32 out."""
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    B, n = shape["graphs"], shape["nodes"]
    k = max(int(math.ceil(cfg["ratio"] * n)), 1)
    bf = count.itemsize(cfg["compute_dtype"])
    ops = [count.bmm("dense_bmm", B, n, n, h, bf, bf, 4),
           count.bmm("dense_bmm", B, k, k, h, bf, bf, 4)]
    if train:  # each layer's input gradient: Âᵀ times the output's
        ops += [count.bmm("dense_bmm", B, k, k, h, bf, bf, 4),
                count.bmm("dense_bmm", B, n, n, h, bf, bf, 4)]
    dense = [(B * n, f, h, False), (B * k, h, h, True), (B, h, h, True),
             (B, h, c, True)]
    flops = sum(count.matmul_flops(m, i, o, train, needs)
                for m, i, o, needs in dense)
    flops += sum(op["flops"] for op in ops) + 2 * B * n * h
    inputs = B * n * f * 4 + B * n * n * bf  # features, normalized adjacency
    params = h * f + 3 * h * h + c * h + 4 * h + c
    state = params * 4 * (4 if train else 1)
    nbytes = inputs * (2 if train else 1) + state + B * c * 4
    return dict(ops=ops, flops=flops, bytes=nbytes)
