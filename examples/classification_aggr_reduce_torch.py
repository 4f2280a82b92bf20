"""Graph classification with swappable aggregation readouts on the
PyTorch port ``tgp_tpu_torch`` (the twin of
``examples/classification_aggr_reduce.py``): GCN → top-k → GCN →
``AggrReduce`` readout → two-layer head, trained with Adam.

    python -m examples.classification_aggr_reduce_torch set2set   # on the GPU
    python -m examples.classification_aggr_reduce_torch lstm --device cpu

The readout is any alias of ``tgp_tpu_torch.reduce.aggr.aggr_aliases()``
(the reference example uses ``sum``, ``mean``, ``lstm`` and ``set2set``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.data.loaders import GraphLoader
from tgp_tpu_torch.datasets import SyntheticGraphClassification
from tgp_tpu_torch.mp.gcn import GCNConv
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.reduce.aggr import AggrReduce
from tgp_tpu_torch.utils.linear import lecun_normal_linear


class Net(nn.Module):
    """GCN → ``pooler`` (default top-k, ratio 0.5) → GCN → ``AggrReduce``
    (``aggr``, with ``aggr_kwargs``) → head.  The names map onto the flax
    ``Net``'s: ``conv``/``conv_1`` its ``GCNConv_0``/``GCNConv_1``,
    ``aggr_reduce`` its ``AggrReduce_0``, ``dense_0`` (classes) and
    ``dense_1`` (hidden) its ``Dense_0`` and ``Dense_1``, which it creates
    in that order."""

    def __init__(self, in_channels: int, aggr: str = "mean",
                 num_classes: int = 3, hidden: int = 32,
                 pooler: Optional[nn.Module] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 **aggr_kwargs):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.conv = GCNConv(in_channels, hidden, **kw)
        self.pooler = (get_pooler("topk", in_channels=hidden, ratio=0.5, **kw)
                       if pooler is None else pooler)
        self.conv_1 = GCNConv(hidden, hidden, **kw)
        self.aggr_reduce = AggrReduce(aggr, in_channels=hidden, **kw,
                                      **aggr_kwargs)
        self.dense_1 = lecun_normal_linear(self.aggr_reduce.out_channels,
                                           hidden, generator=generator)
        self.dense_0 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, batch) -> torch.Tensor:
        h = F.relu(self.conv(batch))
        g = self.pooler(batch.with_features(h)).graph
        h = F.relu(self.conv_1(g, g.x))
        z = self.aggr_reduce(h, None, node_graph=g.node_graph,
                             num_graphs=g.num_graphs, node_mask=g.node_mask)
        return self.dense_0(F.relu(self.dense_1(z)))


def main(aggr: str = "mean", epochs: int = 12, verbose: bool = True,
         device="cuda", seed: int = 0):
    """Train ``epochs`` epochs on the synthetic dataset (weights drawn
    from ``seed``) and return the test accuracy."""
    device = resolve_device(device)
    graphs, labels = SyntheticGraphClassification(
        num_graphs=240, num_features=8, seed=5).generate()
    train = GraphLoader(graphs[:200], labels[:200], batch_size=32,
                        shuffle=True, device=device)
    test = GraphLoader(graphs[200:], labels[200:], batch_size=32,
                       pad_nodes=train.pad_nodes, pad_edges=train.pad_edges,
                       max_nodes=train.max_nodes, device=device)
    # the JAX example draws a batch to initialise its model, which advances
    # the loader's shuffle: drawing one here gives the same batches
    next(iter(train))
    model = Net(graphs[0][0].shape[1], aggr, device=device,
                generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    t0 = time.time()
    for _ in range(epochs):
        for batch, y in train:
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(batch),
                                   torch.as_tensor(y, device=device).long())
            loss.backward()
            opt.step()

    # a short batch repeats graphs: count each test graph once
    correct, seen = [], set()
    with torch.no_grad():
        for batch, y, idx in test._iter_with_indices():
            ok = model(batch).argmax(-1).cpu().numpy() == y
            for j, i in enumerate(idx):
                if int(i) not in seen:
                    seen.add(int(i))
                    correct.append(ok[j])
    acc = float(np.mean(correct))
    if verbose:
        print(f"[aggr={aggr}] test acc {acc:.3f} ({time.time()-t0:.1f}s)")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("aggr", nargs="?", default="mean")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.aggr, a.epochs, device=a.device, seed=a.seed)
