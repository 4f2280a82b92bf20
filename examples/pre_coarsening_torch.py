"""Precoarsened training on the PyTorch port ``tgp_tpu_torch`` (the twin
of ``examples/pre_coarsening.py``): the selection runs once on the host
(:class:`~tgp_tpu_torch.precoarsen.PreCoarsening`), and the model applies
the levels' reduce and a GCN per level: GCN → (reduce → GCN) per level →
sum readout → two-layer head, trained with Adam.

    python -m examples.pre_coarsening_torch graclus          # on the GPU
    python -m examples.pre_coarsening_torch mixed --device cpu

Schedules: ``graclus`` (two Graclus levels), ``mixed`` (NDP, then
Graclus), ``eigen`` (EigenPool with k = 12, then k = 4), or any alias of
``tgp_tpu_torch.precoarsen.PRECOARSENERS`` for two levels of it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.data.pooled_loader import PooledGraphLoader
from tgp_tpu_torch.datasets import SyntheticGraphClassification
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.precoarsen import PreCoarsening
from tgp_tpu_torch.reduce.base import base_reduce
from tgp_tpu_torch.reduce.eigenpool import eigenpool_reduce
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.utils.linear import lecun_normal_linear


class PrecoarsenedNet(nn.Module):
    """GCN, then per level: the level's reduce (EigenPool's mode-major
    one where it carries modes), placed in the level's node space, and a
    GCN over its pooled graph; a sum readout and a two-layer head.

    ``level_modes[i]``: level *i*'s eigenvector modes (0 for the other
    kinds), which widen a level's input to ``modes · hidden``; default
    ``num_levels`` zeros.  The names map onto the flax model's: ``conv``
    its ``GCNConv_0``, ``conv_<i>`` its ``GCNConv_<i>``, ``dense_0``
    (classes) and ``dense_1`` (hidden) its ``Dense_0`` and ``Dense_1``."""

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 32,
                 num_levels: int = 2, level_modes: Optional[Sequence[int]] = None,
                 *, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        modes = list(level_modes) if level_modes is not None else [0] * num_levels
        self.num_levels = len(modes)
        kw = dict(device=device, generator=generator)
        self.conv = GCNConv(in_channels, hidden, **kw)
        for i, m in enumerate(modes, start=1):
            setattr(self, f"conv_{i}", GCNConv(max(m, 1) * hidden, hidden,
                                               **kw))
        self.dense_1 = lecun_normal_linear(hidden, hidden, generator=generator)
        self.dense_0 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, batch, level_batches) -> torch.Tensor:
        h = F.relu(self.conv(batch))
        g = batch
        for i, lb in enumerate(level_batches, start=1):
            if lb.so.num_modes:
                x_pool = eigenpool_reduce(h, lb.so)
            else:
                x_pool = base_reduce(h, lb.so)
            h = lb.place_features(x_pool)
            g = lb.graph
            h = F.relu(getattr(self, f"conv_{i}")(g, h))
        z = global_reduce(h, node_graph=g.node_graph,
                          num_graphs=g.num_graphs, node_mask=g.node_mask,
                          op="sum")
        return self.dense_0(F.relu(self.dense_1(z)))


def schedule_transform(schedule: str) -> PreCoarsening:
    """The example's :class:`PreCoarsening` for ``schedule``."""
    if schedule == "mixed":
        return PreCoarsening(poolers=[("ndp", {}), ("graclus", {})])
    if schedule == "eigen":
        # k shrinks level to level: pooling a K-node coarse graph into K
        # singleton clusters would zero Θ (a singleton cluster writes its
        # self-loop weight, as the reference does)
        return PreCoarsening(poolers=[("eigen", {"k": 12}),
                                      ("eigen", {"k": 4})])
    return PreCoarsening(poolers=schedule, levels=2)


def level_modes(pooled_graph) -> list:
    """Each level's eigenvector modes (0 for the other kinds) of a
    transformed graph ``(..., levels)``."""
    return [int(lv.get("num_modes", 0)) for lv in pooled_graph[-1]]


def main(schedule: str = "graclus", epochs: int = 15, verbose: bool = True,
         device="cuda", seed: int = 0):
    """Precoarsen the synthetic dataset, train ``epochs`` epochs (weights
    drawn from ``seed``) and return the test accuracy."""
    device = resolve_device(device)
    graphs, labels = SyntheticGraphClassification(
        num_graphs=240, num_features=8, seed=11).generate()
    tf = schedule_transform(schedule)
    t0 = time.time()
    pooled_graphs = [tf(g) for g in graphs]
    if verbose:
        print(f"precoarsened {len(graphs)} graphs in {time.time()-t0:.1f}s")

    n_train = 200
    train = PooledGraphLoader(pooled_graphs[:n_train], labels[:n_train],
                              batch_size=32, shuffle=True, device=device)
    test = PooledGraphLoader(pooled_graphs[n_train:], labels[n_train:],
                             batch_size=32, device=device)
    # the JAX example draws a batch to initialise its model, which advances
    # the loader's shuffle: drawing one here gives the same batches
    next(iter(train))
    model = PrecoarsenedNet(graphs[0][0].shape[1], 3,
                            level_modes=level_modes(pooled_graphs[0]),
                            device=device,
                            generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    for epoch in range(epochs):
        accs = []
        for batch, lbs, y in train:
            y = torch.as_tensor(y, device=device).long()
            opt.zero_grad(set_to_none=True)
            logits = model(batch, lbs)
            F.cross_entropy(logits, y).backward()
            opt.step()
            accs.append(float((logits.argmax(-1) == y).float().mean()))
        if verbose:
            print(f"epoch {epoch:03d} train-acc {np.mean(accs):.3f}")

    # a short batch repeats graphs: count each test graph once
    correct, seen = [], set()
    with torch.no_grad():
        for batch, lbs, y, idx in test._iter_with_indices():
            ok = model(batch, lbs).argmax(-1).cpu().numpy() == y
            for j, i in enumerate(idx):
                if int(i) not in seen:
                    seen.add(int(i))
                    correct.append(ok[j])
    acc = float(np.mean(correct))
    if verbose:
        print(f"[{schedule}] precoarsened test acc {acc:.3f}")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("schedule", nargs="?", default="graclus")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.schedule, a.epochs, device=a.device, seed=a.seed)
