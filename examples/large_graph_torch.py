"""Single large-graph training on the PyTorch port ``tgp_tpu_torch`` (the
twin of ``examples/large_graph.py``): one receiver-sorted graph through
GCN → top-k pool → GCN → readout.

``from_graphs(sort_edges=True)`` collates the static CSR metadata
(``row_ptr`` and the sender-sorted transpose layout), so at the default
size (65,536 nodes, 983,040 edges) the GCN takes its CSR branch and runs
K1 (``spmm_csr``, forward and backward) on the card; top-k's masked
pooling keeps the sorted node space, and the readout's sum runs K4.

    python -m examples.large_graph_torch                    # on the GPU
    python -m examples.large_graph_torch 256 6 --device cpu # a small run
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.graph import from_graphs
from tgp_tpu_torch.models.classifiers import PoolingClassifier
from tgp_tpu_torch.poolers import get_pooler

#: the last ``main()`` run: ``ms_per_step``, ``edges_per_s``, ``steps``,
#: ``n_edges``, ``loss``
LAST_RUN: dict = {}


def make_community_graph(n, avg_degree, num_classes=3, feat=64, seed=0):
    """Planted-partition graph: label = community, features = noisy
    community indicator — learnable by one round of message passing (the
    same arrays as ``examples/large_graph.py``'s for a seed)."""
    rng = np.random.default_rng(seed)
    com = rng.integers(0, num_classes, n)
    e = n * avg_degree // 2
    s = rng.integers(0, n, e)
    # 70% of edges stay within the community: rewire the receiver to a
    # random member of the sender's community
    same = rng.random(e) < 0.7
    r = rng.integers(0, n, e)
    perm = rng.permutation(n)
    by_com = {c: perm[com[perm] == c] for c in range(num_classes)}
    for c in range(num_classes):
        idx = np.where(same & (com[s] == c))[0]
        r[idx] = rng.choice(by_com[c], size=idx.size)
    ei = np.stack([np.concatenate([s, r]), np.concatenate([r, s])])
    x = np.eye(num_classes, dtype=np.float32)[com]
    x = np.concatenate(
        [x + 0.5 * rng.normal(size=(n, num_classes)).astype(np.float32),
         rng.normal(size=(n, feat - num_classes)).astype(np.float32)], 1)
    y = int(np.bincount(com, minlength=num_classes).argmax())
    return (x, ei), np.asarray([y], np.int32), com


def setup(n=65536, avg_degree=15, *, device="cuda", seed: int = 0):
    """``(model, batch, y, n_edges)``: the example's graph collated
    receiver-sorted and its ``PoolingClassifier`` (top-k 0.5, hidden 128,
    bf16), the weights drawn from one generator seeded ``seed``."""
    device = resolve_device(device)
    graph, y, _ = make_community_graph(n, avg_degree)
    batch = from_graphs([graph], sort_edges=True, device=device)
    n_edges = int(batch.edge_mask.sum())
    g = torch.Generator().manual_seed(seed)
    pooler = get_pooler("topk", in_channels=128, ratio=0.5, device=device,
                        generator=g)
    model = PoolingClassifier(pooler, num_classes=3, hidden=128,
                              compute_dtype=torch.bfloat16,
                              in_channels=graph[0].shape[1], device=device,
                              generator=g)
    return model, batch, torch.as_tensor(y, device=device).long(), n_edges


def train_step(model, opt, batch, y):
    opt.zero_grad(set_to_none=True)
    logits, _ = model(batch)
    loss = F.cross_entropy(logits.float(), y)
    loss.backward()
    opt.step()
    return loss.detach()


def main(n=65536, avg_degree=15, device="cuda"):
    model, batch, y, n_edges = setup(n, avg_degree, device=device)
    device = batch.x.device
    print(f"graph: N={batch.num_nodes} E={n_edges} "
          f"(sorted CSR aux: {batch.row_ptr is not None}) device={device}")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model.train()

    steps = 30 if n >= 4096 else 5
    loss = train_step(model, opt, batch, y)  # warm: timing starts after it
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        loss = train_step(model, opt, batch, y)
    loss = float(loss)  # waits for the last step
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)
    LAST_RUN.clear()
    LAST_RUN.update(ms_per_step=dt * 1e3, edges_per_s=n_edges / dt,
                    steps=steps, n_edges=n_edges, loss=loss)
    print(f"loss {loss:.4f}  {dt * 1e3:.1f} ms/step  "
          f"{n_edges / dt / 1e6:.1f} M edges/s")
    return loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", nargs="?", type=int, default=65536)
    ap.add_argument("avg_degree", nargs="?", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n, a.avg_degree, device=a.device)
