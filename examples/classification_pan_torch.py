"""PANConv + PANPooling classification on the PyTorch port
``tgp_tpu_torch`` (the twin of ``examples/classification_pan.py``).

    python -m examples.classification_pan_torch                # on the GPU
    python -m examples.classification_pan_torch --device cpu
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
from tgp_tpu_torch.mp.pan import PANConv
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.reduce.global_reduce import global_reduce
from tgp_tpu_torch.utils.linear import lecun_normal_linear


class PANNet(nn.Module):
    """PANConv (MET filter of 3 hops, the dense MET returned) → PANPooling
    (ratio 0.25, the exact full-MET connect) → GCN → sum readout → head.
    ``dense_1`` and ``dense_0`` are the flax model's ``Dense_1`` (hidden)
    and ``Dense_0`` (classes), which it creates in that order."""

    def __init__(self, in_channels: int, num_classes: int = 3,
                 hidden: int = 64, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.pan_conv = PANConv(in_channels, hidden, filter_size=3,
                                return_dense_met=True, **kw)
        self.pooler = get_pooler("pan", in_channels=hidden, ratio=0.25,
                                 device=device)
        self.conv = GCNConv(hidden, hidden, **kw)
        self.dense_1 = lecun_normal_linear(hidden, hidden, generator=generator)
        self.dense_0 = lecun_normal_linear(hidden, num_classes,
                                           generator=generator)
        self.to(device)

    def forward(self, batch) -> torch.Tensor:
        h, met_deg, met_w, met_dense = self.pan_conv(batch)
        met_batch = batch.replace(x=F.relu(h), edge_weight=met_w)
        out = self.pooler(met_batch, met_degree=met_deg, met_dense=met_dense)
        g = out.graph
        h = F.relu(self.conv(g, g.x))
        z = global_reduce(h, node_graph=g.node_graph,
                          num_graphs=g.num_graphs, node_mask=g.node_mask,
                          op="sum")
        return self.dense_0(F.relu(self.dense_1(z)))


def main(epochs: int = 12, verbose: bool = True, device="cuda",
         seed: int = 0):
    device = resolve_device(device)
    graphs, labels = SyntheticGraphClassification(
        num_graphs=240, num_features=8, seed=8).generate()
    train = GraphLoader(graphs[:200], labels[:200], batch_size=32,
                        shuffle=True, device=device)
    test = GraphLoader(graphs[200:], labels[200:], batch_size=32,
                       pad_nodes=train.pad_nodes, pad_edges=train.pad_edges,
                       max_nodes=train.max_nodes, device=device)
    model = PANNet(graphs[0][0].shape[1], device=device,
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
        print(f"[pan] test acc {acc:.3f} ({time.time()-t0:.1f}s)")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.epochs, device=a.device, seed=a.seed)
