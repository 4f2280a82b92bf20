"""TVGNN clustering on the PyTorch port ``tgp_tpu_torch`` (the twin of
``examples/clustering_tvgnn.py``): two GTVConv layers →
AsymCheegerCut pooling, trained on its total-variation and balance losses
and scored by NMI against the CSBM communities.

    python -m examples.clustering_tvgnn_torch                 # on the GPU
    python -m examples.clustering_tvgnn_torch --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from examples.clustering_torch import predict
from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.datasets.csbm import CSBMDataset
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.models.clustering import ClusteringModel, nmi_score
from tgp_tpu_torch.poolers import get_pooler

#: TVGNN's AsymCheegerCut loss coefficients (the JAX example's)
TOTVAR_COEFF, BALANCE_COEFF = 0.785, 0.514


def build_model(hidden: int, in_channels: int, k: int = 4, *,
                device="cuda", seed: int = 0, alias: str = "acc"
                ) -> ClusteringModel:
    """GTVConv layers and AsymCheegerCut (``"acc"`` or ``"acc_u"``), the
    weights from one generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    pooler = get_pooler(alias, in_channels=hidden, k=k,
                        totvar_coeff=TOTVAR_COEFF,
                        balance_coeff=BALANCE_COEFF, device=device,
                        generator=g)
    return ClusteringModel(pooler, hidden=hidden, mp_type="gtv",
                           in_channels=in_channels, device=device,
                           generator=g)


def main(epochs: int = 200, hidden: int = 32, seed: int = 0,
         verbose: bool = True, device="cuda"):
    device = resolve_device(device)
    ds = CSBMDataset(num_graphs=1, num_nodes=150, num_communities=4,
                     p_in=0.35, p_out=0.03, feature_dim=16, mu=1.2, seed=1)
    x, ei, labels = ds[0]
    batch = from_graphs([(x, ei)], device=device)
    model = build_model(hidden, batch.num_features, k=4, device=device,
                        seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    t0 = time.time()
    model.train()
    for epoch in range(epochs):
        opt.zero_grad(set_to_none=True)
        _, out = model(batch)
        loss = out.loss_sum()
        loss.backward()
        opt.step()
        if verbose and epoch % 25 == 0:
            print(f"epoch {epoch:04d} loss {float(loss):+.4f}")

    nmi = nmi_score(labels, predict(model, batch, x.shape[0]))
    if verbose:
        print(f"[tvgnn/acc] NMI {nmi:.3f}  ({time.time()-t0:.1f}s)")
    return nmi


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(epochs=a.epochs, hidden=a.hidden, seed=a.seed, device=a.device)
