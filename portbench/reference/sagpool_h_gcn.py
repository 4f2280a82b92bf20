"""Plain reference of SAGPool_h, the hierarchical Self-Attention Graph
Pooling classifier (Lee, Lee & Kang, ICML 2019, arXiv:1904.08082, §3.2;
the authors' ``networks.py::Net`` and ``layers.py::SAGPool``), over a
list of graphs.

For each block l = 1..L (``cfg["num_blocks"]``), on the graph ``G_l``
(``G_1`` the input; GCN as in :mod:`portbench.reference.sparse_topk_gcn`):

* ``H_l = relu(Â_l X_l W_lᵀ + b_l)``;
* the score, a GCN to width 1: ``s_l = Â_l H_l θ_lᵀ + β_l``;
* each graph keeps its ``ceil(ratio·n_g)`` best nodes by ``tanh(s_l)``,
  ties to the lower index;
* ``X_{l+1} = H_l[kept] · tanh(s_l[kept])``, and ``G_{l+1}`` is the kept
  nodes' subgraph without loop edges;
* the block's readout ``r_l = [max ‖ mean]`` over each graph's rows of
  ``X_{l+1}``.

Then ``z = Σ_l r_l`` and ``logits = relu(relu(z Aᵀ + a) Bᵀ + b) Cᵀ + c``
(the head's hidden widths ``cfg["head"]``).

Departures from the source, each a choice of the configuration:

* no dropout (the source drops half of the head's first layer's output
  in training): a random mask cannot be followed;
* the kept set is ranked by ``tanh(s_l)``, the gate, as the port ranks
  it; the source ranks by ``s_l``.  tanh is increasing, so the sets
  differ only where float32 rounds two scores' tanh to one value
  (|s| above ~9), and then the tie goes to the lower index;
* the logits are returned before the source's ``log_softmax`` (the loss,
  a cross-entropy, applies it).

Float32 throughout, TF32 off.  ``quant`` rounds the GCN layers' operands
where the configuration computes in its compute dtype (the control); the
score is float32, as the port computes it.  The selection may be given
(``keep``): a bool ``[L, N]`` over the batch's node slots (the first
``n`` are the graphs' nodes in order), level l's row the input nodes
still kept after block l.  The reference then judges each level by its
own scores and pools by it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.plain import identity, precision, strict_fp32
from portbench.reference.sparse_topk_gcn import Packed, _gcn, _rank

__all__ = ["param_shapes", "pack", "forward", "work"]


def param_shapes(cfg: dict) -> dict:
    """Each parameter's shape and the std it is drawn with."""
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    out = {}
    for l in range(cfg["num_blocks"]):
        fi = f if l == 0 else h
        out.update({f"W{l}": ((h, fi), 1 / math.sqrt(fi)),
                    f"b{l}": ((h,), 0.1),
                    f"t{l}": ((1, h), 1 / math.sqrt(h)),
                    f"u{l}": ((1,), 0.1)})
    widths = [len(_ops(cfg)) * h, *cfg["head"], c]
    for j, (a, b) in enumerate(zip(widths, widths[1:])):
        out.update({f"D{j}": ((b, a), 1 / math.sqrt(a)), f"d{j}": ((b,), 0.1)})
    return out


def _ops(cfg: dict) -> list:
    ops = cfg["readout"].split("_")
    if not set(ops) <= {"max", "mean"}:
        raise ValueError(f"readout {cfg['readout']!r} is not in the reference")
    return ops


def pack(graphs, device) -> Packed:
    return Packed(graphs, device)


def _readout(x, graph, counts, B, ops):
    """``[max ‖ mean]`` (in ``ops``' order) of each graph's rows."""
    idx = graph[:, None].expand(-1, x.shape[1])
    parts = []
    for op in ops:
        if op == "max":
            parts.append(torch.zeros(B, x.shape[1], device=x.device)
                         .scatter_reduce(0, idx, x, "amax",
                                         include_self=False))
        else:
            total = torch.zeros(B, x.shape[1], device=x.device).index_add(
                0, graph, x)
            parts.append(total / counts.clamp_min(1).to(x.dtype)[:, None])
    return torch.cat(parts, dim=1)


def _gap(score, keep, graph, B):
    """The widest amount by which, in one graph, a kept node's score lies
    below a dropped one's (0 where none does)."""
    neg = torch.full((B,), -math.inf, device=score.device)
    pos = torch.full((B,), math.inf, device=score.device)
    top_dropped = neg.scatter_reduce(0, graph[~keep], score[~keep], "amax")
    low_kept = pos.scatter_reduce(0, graph[keep], score[keep], "amin")
    return float(torch.clamp(top_dropped - low_kept, min=0)
                 .nan_to_num(0.0).max())


def forward(params: dict, g: Packed, cfg: dict, keep=None, quant=None):
    """Logits ``[graphs, classes]`` and what the selection was: ``keep``
    (bool ``[L, n]``, each level's kept input nodes) and ``gap``, the
    widest misorder over the levels (see :func:`_gap`), or inf where a
    graph keeps the wrong number of nodes at some level."""
    strict_fp32()
    q = precision(quant)
    B, L, ops = g.num_graphs, cfg["num_blocks"], _ops(cfg)
    if keep is not None:
        keep = torch.as_tensor(keep).to(g.x.device, torch.bool)[:, :g.n]
    x, s, r, n, graph = g.x, g.s, g.r, g.n, g.graph
    ids = torch.arange(g.n, device=x.device)  # each node's input slot
    counts = g.counts
    kept_all = torch.zeros(L, g.n, dtype=torch.bool, device=x.device)
    gap, z = 0.0, 0.0
    for l in range(L):
        h = F.relu(_gcn(x, s, r, n, params[f"W{l}"], params[f"b{l}"], q))
        score = torch.tanh(_gcn(h, s, r, n, params[f"t{l}"], params[f"u{l}"],
                                identity)[:, 0])
        k = torch.ceil(cfg["ratio"] * counts.to(torch.float32)).long()
        if keep is None:
            kl = _rank(score.detach(), graph) < k[graph]
        else:
            kl = keep[l][ids]
            if int(keep[l].sum()) != int(kl.sum()):  # kept, not a node here
                gap = math.inf
        kept = torch.bincount(graph[kl], minlength=B)
        gap = max(gap, _gap(score.detach(), kl, graph, B)
                  if bool((kept == k).all()) else math.inf)

        idx = torch.nonzero(kl).squeeze(1)
        new_id = torch.full((n,), -1, dtype=torch.long, device=x.device)
        new_id[idx] = torch.arange(idx.shape[0], device=x.device)
        e = kl[s] & kl[r] & (s != r)
        x = h[idx] * score[idx][:, None]
        s, r, n = new_id[s[e]], new_id[r[e]], idx.shape[0]
        graph, ids, counts = graph[idx], ids[idx], kept
        kept_all[l, ids] = True
        z = z + _readout(x, graph, counts, B, ops)

    heads = len(cfg["head"]) + 1
    for j in range(heads):
        z = z @ params[f"D{j}"].T + params[f"d{j}"]
        if j < heads - 1:
            z = F.relu(z)
    return z, dict(keep=kept_all, gap=gap)


def work(cfg: dict, shape: dict, train: bool, count) -> dict:
    """Operations and bytes of one request or step, from its shapes:
    ``shape`` has ``graphs``, ``nodes`` (real nodes entering each block,
    and the last block's kept nodes) and ``edges`` (real edges of each
    block's graph, loops dropped after the first).  ``count`` is
    :mod:`portbench.harness.counting`.  No kernel of a counted operation
    runs (``ops`` is empty); ``flops`` and ``bytes`` are the whole
    request's or step's compulsory work: every block's GCN (its product
    and its SpMM with the self-loops, in the compute dtype), its scorer
    (f32), the gate and readouts, and the head."""
    f, h, c = cfg["in_channels"], cfg["hidden"], cfg["num_classes"]
    ns, es, b = shape["nodes"], shape["edges"], shape["graphs"]
    bf = count.itemsize(cfg["compute_dtype"])
    passes = 2 if train else 1  # the forward; the input's gradient
    flops = 0
    for l, (n, e) in enumerate(zip(ns, es)):
        flops += count.matmul_flops(n, f if l == 0 else h, h, train, l > 0)
        flops += passes * count.spmm("", n, e + n, h, bf)["flops"]
        flops += count.matmul_flops(n, h, 1, train, True)
        flops += passes * count.spmm("", n, e + n, 1, 4)["flops"]
        flops += passes * 3 * ns[l + 1] * h  # gate, max and mean readouts
    widths = [len(_ops(cfg)) * h, *cfg["head"], c]
    flops += sum(count.matmul_flops(b, i, o, train, True)
                 for i, o in zip(widths, widths[1:]))
    inputs = ns[0] * f * 4 + es[0] * 2 * 4  # features; senders, receivers
    params = sum(math.prod(shape_) for shape_, _ in
                 param_shapes(cfg).values())
    state = params * 4 * (4 if train else 1)  # + gradient and Adam moments
    nbytes = inputs * (2 if train else 1) + state + b * c * 4
    return dict(ops=[], flops=flops, bytes=nbytes)
