"""Graph classification on the PyTorch port ``tgp_tpu_torch`` (the twin
of ``examples/classification.py``): GCN → pooler → GCN → sum readout →
linear head, trained with Adam.

    python -m examples.classification_torch sag               # on the GPU
    python -m examples.classification_torch asap --device cpu

Poolers: the port's ``get_pooler`` aliases (``topk``, ``sag``, ``asap``,
``pan``, ``ec``, ``graclus``, ``kmis``, ``nopool``, ``lap``, ``mincut``,
``diff``, ``dmon``, ``hosc``, ``jb``, ``acc``, ``bnpool``, the last
seven also as ``<alias>_u``, and ``maxcut``).  Only the ``synthetic`` dataset is ported so far.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from tgp_tpu_torch import DenseGraphBatch, PoolingClassifier, prepare_batch
from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.data.loaders import GraphLoader, compute_budgets
from tgp_tpu_torch.datasets import SyntheticGraphClassification
from tgp_tpu_torch.poolers import get_pooler
from tgp_tpu_torch.src import DenseSRCPooling

#: which pipeline the last ``main()`` run took ("dense" | "sparse")
LAST_ROUTE = None
#: the ROADMAP.md item that ports the datasets and checkpoints, by name
TODO_ITEM = "datasets/* and utils/{checkpoint,cheatsheet,typing}.py"


def load_dataset(dataset: str, data_dir: str | None = None):
    """``(graphs, labels, num_classes)`` of a named dataset."""
    if dataset == "synthetic":
        graphs, labels = SyntheticGraphClassification(
            num_graphs=360, num_features=8, seed=42).generate()
        return graphs, labels, 3
    raise NotImplementedError(
        f"dataset {dataset!r} is not ported: the TU, GCB and EXPWL1 "
        f"readers come with ROADMAP.md's queue 1 item {TODO_ITEM!r}")


def build_model(alias: str, num_classes: int, hidden: int,
                in_channels: int, *, pre_normalized: bool = False,
                use_kernel=None, device="cuda",
                seed: int = 0) -> PoolingClassifier:
    """The example's classifier, its weights drawn from one seeded
    generator; ``use_kernel`` is ``PoolingClassifier``'s (True runs a
    dense pooled graph's GCN products in K3).  BNPool's Beta draws (and
    ``bnpool_u``'s negatives) come from a second generator on the device,
    seeded ``seed + 1``, as the JAX example threads its ``"sample"``
    stream."""
    g = torch.Generator().manual_seed(seed)
    sample = torch.Generator(device=device).manual_seed(seed + 1)
    pooler = get_pooler(alias, in_channels=hidden, ratio=0.5, k=16,
                        device=device, generator=g, sample_generator=sample)
    return PoolingClassifier(pooler, num_classes=num_classes, hidden=hidden,
                             in_channels=in_channels,
                             pre_normalized=pre_normalized,
                             use_kernel=use_kernel, device=device,
                             generator=g)


def main(alias: str = "topk", epochs: int = 20, batch_size: int = 32,
         hidden: int = 64, seed: int = 0, verbose: bool = True,
         checkpoint_dir: str | None = None, dataset: str = "synthetic",
         data_dir: str | None = None, device="cuda"):
    if checkpoint_dir:
        raise NotImplementedError(
            "checkpoints are not ported: they come with ROADMAP.md's queue "
            f"1 item {TODO_ITEM!r}")
    device = resolve_device(device)
    graphs, labels, num_classes = load_dataset(dataset, data_dir)
    n_train = int(0.85 * len(graphs)) if dataset != "synthetic" else 300
    # one padding budget for train and test: the elementwise max of both
    # splits' worst cases
    b_tr = compute_budgets(graphs[:n_train], batch_size)
    b_te = compute_budgets(graphs[n_train:], batch_size)
    pad_nodes, pad_edges, max_nodes = (max(a, b) for a, b in zip(b_tr, b_te))
    budget = dict(batch_size=batch_size, pad_nodes=pad_nodes,
                  pad_edges=pad_edges, max_nodes=max_nodes, device=device)
    train_loader = GraphLoader(graphs[:n_train], labels[:n_train],
                               shuffle=True, seed=seed, **budget)
    test_loader = GraphLoader(graphs[n_train:], labels[n_train:], **budget)

    # the regime map densifies a batch of small graphs once, on the way into
    # the step, for a pooler instance that takes a dense batch (top-k, the
    # batched dense family); the other poolers (LaPool, the "_u" modes)
    # keep the batch sparse.  The dense family's losses read the raw
    # adjacency, so only the other poolers get it GCN-normalized.
    batch0, _ = next(iter(train_loader))
    model = build_model(alias, num_classes, hidden, batch0.num_features,
                        device=device, seed=seed)
    global LAST_ROUTE
    LAST_ROUTE = ("dense" if isinstance(
        prepare_batch(batch0, pooler=model.pooler), DenseGraphBatch)
        else "sparse")
    normalize = (LAST_ROUTE == "dense"
                 and not isinstance(model.pooler, DenseSRCPooling))
    if normalize:  # the same weights; the pre layers skip normalization
        model = build_model(alias, num_classes, hidden,
                            batch0.num_features, pre_normalized=True,
                            device=device, seed=seed)

    def prep(b):
        return prepare_batch(b, pooler=model.pooler, normalize=normalize)

    if verbose:
        print(f"[{alias}] pipeline: {LAST_ROUTE} on {device}")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    t0 = time.time()
    for epoch in range(epochs):
        model.train()
        losses, accs = [], []
        for batch, y in train_loader:
            y = torch.as_tensor(y, device=device).long()
            opt.zero_grad(set_to_none=True)
            logits, out = model(prep(batch))
            loss = F.cross_entropy(logits, y) + out.loss_sum()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            accs.append(float((logits.argmax(-1) == y).float().mean()))
        if verbose:
            print(f"epoch {epoch:03d} loss {np.mean(losses):.4f} "
                  f"train-acc {np.mean(accs):.3f}")

    model.eval()
    correct, seen = [], set()
    with torch.no_grad():
        for batch, y, idx in test_loader._iter_with_indices():
            logits, _ = model(prep(batch))
            ok = (logits.argmax(-1).cpu().numpy() == y)
            for j, i in enumerate(idx):
                # a short batch repeats graphs: count each test graph once
                if int(i) not in seen:
                    seen.add(int(i))
                    correct.append(ok[j])
    test_acc = float(np.mean(correct))
    if verbose:
        print(f"[{alias}] test acc {test_acc:.3f}  ({time.time()-t0:.1f}s)")
    return test_acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("alias", nargs="?", default="topk")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.alias, epochs=a.epochs, batch_size=a.batch_size, hidden=a.hidden,
         seed=a.seed, checkpoint_dir=a.checkpoint_dir, dataset=a.dataset,
         data_dir=a.data_dir, device=a.device)
