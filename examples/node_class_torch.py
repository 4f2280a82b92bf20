"""Node classification by pool → bottleneck → lift on the PyTorch port
``tgp_tpu_torch`` (the twin of ``examples/node_class.py``): the
hierarchical autoencoder ``PoolLiftNodeClassifier`` on a CSBM graph, half
its nodes labelled for training, scored on the other half.

    python -m examples.node_class_torch topk                  # on the GPU
    python -m examples.node_class_torch mincut --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.datasets.csbm import CSBMDataset
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.models.autoencoder import PoolLiftNodeClassifier
from tgp_tpu_torch.poolers import get_pooler


def build_model(alias: str, num_classes: int, hidden: int,
                in_channels: int, *, device="cuda", seed: int = 0
                ) -> PoolLiftNodeClassifier:
    """The example's model (pooler ``ratio=0.5``, ``k=8``), its weights
    from one generator seeded ``seed``; BNPool's draws from a device
    generator seeded ``seed + 1``."""
    g = torch.Generator().manual_seed(seed)
    sample = torch.Generator(device=device).manual_seed(seed + 1)
    pooler = get_pooler(alias, in_channels=hidden, ratio=0.5, k=8,
                        device=device, generator=g, sample_generator=sample)
    return PoolLiftNodeClassifier(pooler, num_classes=num_classes,
                                  hidden=hidden, in_channels=in_channels,
                                  device=device, generator=g)


def masked_ce(logits, y, train_mask):
    """Cross-entropy averaged over the training nodes."""
    ce = F.cross_entropy(logits, y, reduction="none")
    return torch.where(train_mask, ce, 0.0).sum() / train_mask.sum()


def main(alias: str = "topk", epochs: int = 100, hidden: int = 32,
         seed: int = 0, verbose: bool = True, device="cuda"):
    device = resolve_device(device)
    ds = CSBMDataset(num_graphs=1, num_nodes=160, num_communities=4,
                     p_in=0.3, p_out=0.03, feature_dim=16, mu=1.0, seed=3)
    x, ei, labels = ds[0]
    batch = from_graphs([(x, ei)], device=device)
    n = x.shape[0]
    y = torch.as_tensor(labels, device=device).long()
    rng = np.random.default_rng(seed)
    train_mask = torch.as_tensor(rng.random(n) < 0.5, device=device)

    model = build_model(alias, 4, hidden, batch.num_features, device=device,
                        seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    def accuracy(logits):
        hit = (logits.argmax(-1) == y)[~train_mask]
        return float(hit.float().mean())

    t0 = time.time()
    model.train()
    for epoch in range(epochs):
        opt.zero_grad(set_to_none=True)
        logits, out = model(batch)
        logits = logits[:n]
        loss = masked_ce(logits, y, train_mask) + out.loss_sum()
        loss.backward()
        opt.step()
        if verbose and epoch % 20 == 0:
            print(f"epoch {epoch:04d} loss {float(loss):.4f} "
                  f"val-acc {accuracy(logits.detach()):.3f}")

    model.eval()
    with torch.no_grad():
        logits, _ = model(batch)
    acc = accuracy(logits[:n])
    if verbose:
        print(f"[{alias}] node-class test acc {acc:.3f} "
              f"({time.time()-t0:.1f}s)")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("alias", nargs="?", default="topk")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.alias, epochs=a.epochs, hidden=a.hidden, seed=a.seed,
         device=a.device)
