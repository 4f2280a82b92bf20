"""Train → serve on the PyTorch port ``tgp_tpu_torch`` (the twin of
``examples/inference.py``): a small classifier trained on size-bucketed
batches (``BucketedGraphLoader``: each bucket its own padding budget),
then served through ``Predictor``, which rounds every request batch up to
a geometric bucket, so the number of padded shapes stays bounded whatever
sizes arrive.

    python -m examples.inference_torch topk                  # on the GPU
    python -m examples.inference_torch sag --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from tgp_tpu_torch._device import resolve_device
from tgp_tpu_torch.data.loaders import BucketedGraphLoader
from tgp_tpu_torch.datasets.synthetic import SyntheticGraphClassification
from tgp_tpu_torch.models.classifiers import PoolingClassifier
from tgp_tpu_torch.models.inference import Predictor
from tgp_tpu_torch.poolers import get_pooler

#: what the last ``main()`` served: ``num_compiled`` (buckets after the
#: first wave), ``new_buckets`` (added by the second), ``serve_ms`` (each
#: wave's host time), ``accuracy``, both waves' ``logits`` (in input
#: order), the trained ``model`` and its ``predictor``
LAST_SERVING: dict = {}


def build_model(alias: str, hidden: int, in_channels: int, *,
                device="cuda", seed: int = 0) -> PoolingClassifier:
    """The example's classifier (3 classes, pooler ``ratio=0.5``, ``k=16``),
    its weights drawn from one generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    sample = torch.Generator(device=device).manual_seed(seed + 1)
    pooler = get_pooler(alias, in_channels=hidden, ratio=0.5, k=16,
                        device=device, generator=g, sample_generator=sample)
    return PoolingClassifier(pooler, num_classes=3, hidden=hidden,
                             in_channels=in_channels, device=device,
                             generator=g)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(alias: str = "topk", epochs: int = 8, hidden: int = 32,
         verbose: bool = True, device="cuda"):
    device = resolve_device(device)
    graphs, labels = SyntheticGraphClassification(
        num_graphs=360, num_features=8, seed=42).generate()
    train_g, train_y = graphs[:300], labels[:300]
    test_g, test_y = graphs[300:], labels[300:]

    loader = BucketedGraphLoader(train_g, train_y, batch_size=32,
                                 num_buckets=3, shuffle=True, seed=0,
                                 device=device)
    model = build_model(alias, hidden, train_g[0][0].shape[1],
                        device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    model.train()
    for ep in range(epochs):
        losses = []
        for b, y in loader:
            opt.zero_grad(set_to_none=True)
            logits, out = model(b)
            loss = F.cross_entropy(
                logits, torch.as_tensor(y, device=device).long()) \
                + out.loss_sum()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        if verbose:
            print(f"epoch {ep:03d} loss {np.mean(losses):.4f}")

    # ---- serving: arbitrary-size request stream, bounded buckets ---------
    model.eval()
    pred = Predictor(lambda b: model(b)[0], batch_size=8, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits = pred(test_g)
    first_ms = 1e3 * (time.perf_counter() - t0)
    acc = float((logits.argmax(-1) == test_y).mean())
    # second wave: the same size distribution → no new bucket
    before = pred.num_compiled
    t0 = time.perf_counter()
    again = pred(test_g[::-1])
    second_ms = 1e3 * (time.perf_counter() - t0)
    new = pred.num_compiled - before
    LAST_SERVING.clear()
    LAST_SERVING.update(num_compiled=before, new_buckets=new,
                        serve_ms=(first_ms, second_ms), accuracy=acc,
                        requests=len(test_g), logits=logits,
                        logits_reversed=again[::-1], model=model,
                        predictor=pred)
    if verbose:
        print(f"served {len(test_g)} graphs in {first_ms / 1e3:.2f}s "
              f"({before} buckets), test acc {acc:.3f}")
        print(f"second wave: {new} new buckets")
    if new:
        raise RuntimeError(f"the second wave of the same sizes added {new} "
                           "buckets")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("alias", nargs="?", default="topk")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.alias, epochs=a.epochs, hidden=a.hidden, device=a.device)
