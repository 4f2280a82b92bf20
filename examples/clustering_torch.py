"""Transductive node clustering on the PyTorch port ``tgp_tpu_torch`` (the
twin of ``examples/clustering.py``): two GCN layers → a dense pooler whose
soft assignment is the clustering, trained on the pooler's losses alone
and scored by NMI against the CSBM communities.  The ``_u`` aliases run
the unbatched mode.

    python -m examples.clustering_torch mincut              # on the GPU
    python -m examples.clustering_torch mincut_u --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.datasets.csbm import CSBMDataset
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.models.clustering import ClusteringModel, nmi_score
from tgp_tpu_torch.poolers import get_pooler


def build_model(alias: str, hidden: int, in_channels: int, k: int = 4, *,
                device="cuda", seed: int = 0) -> ClusteringModel:
    """The example's model, its weights drawn from one seeded generator;
    BNPool's draws come from a second generator on the device, seeded
    ``seed + 1``, as the JAX example threads its ``"sample"`` stream."""
    g = torch.Generator().manual_seed(seed)
    sample = torch.Generator(device=device).manual_seed(seed + 1)
    pooler = get_pooler(alias, in_channels=hidden, k=k, device=device,
                        generator=g, sample_generator=sample)
    return ClusteringModel(pooler, hidden=hidden, in_channels=in_channels,
                           device=device, generator=g)


def predict(model: ClusteringModel, batch, n: int):
    """Each real node's cluster: the argmax of its row of ``s``."""
    model.eval()
    with torch.no_grad():
        s, _ = model(batch)
    s = s[0] if s.dim() == 3 else s
    return s.argmax(-1)[:n].cpu().numpy()


def main(alias: str = "mincut", epochs: int = 150, hidden: int = 32,
         seed: int = 0, verbose: bool = True, device="cuda"):
    device = resolve_device(device)
    ds = CSBMDataset(num_graphs=1, num_nodes=150, num_communities=4,
                     p_in=0.35, p_out=0.03, feature_dim=16, mu=1.2, seed=1)
    x, ei, labels = ds[0]
    batch = from_graphs([(x, ei)], device=device)
    model = build_model(alias, hidden, batch.num_features, k=4,
                        device=device, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)

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
        print(f"[{alias}] NMI {nmi:.3f}  ({time.time()-t0:.1f}s)")
    return nmi


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("alias", nargs="?", default="mincut")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.alias, epochs=a.epochs, hidden=a.hidden, seed=a.seed,
         device=a.device)
