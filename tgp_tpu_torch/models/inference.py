"""Shape-bucketed batch inference (port of ``tgp_tpu/models/inference.py``).

Each batch's (pad_nodes, pad_edges, max_nodes) budget is rounded up to a
geometric bucket.  PyTorch needs no compile per shape, but the bucket
still fixes the padding and the CSR layout (``row_ptr`` rows) the kernels
see, so serving keeps it; ``num_compiled`` counts the buckets served.
Results are exact: padding is masked by construction, and short batches
are cycle-padded then sliced back.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tgp_tpu_torch import tracing
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import GraphBatch, from_graphs

__all__ = ["Predictor", "geometric_budget"]


def geometric_budget(n: int, base: int = 64, growth: float = 2.0) -> int:
    """Smallest ``base·growth^k`` ≥ ``n`` — the bucket ceiling for a size."""
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1.0, got {growth}")
    b = float(base)
    while b < n:
        b *= growth
    return int(b)


class Predictor:
    """Batch inference under ``torch.inference_mode()``.

    Args:
      apply_fn: ``GraphBatch -> logits`` (e.g. ``lambda b: model(b)[0]``).
      batch_size: graphs per batch.
      node_base/edge_base: smallest bucket ceilings.
      sort_edges: collate receiver-sorted batches with CSR metadata (the
        CUDA SpMM kernel's layout).
      out_width: trailing output width, so an empty input returns
        ``(0, out_width)`` from the first call.
      device: where batches go (default ``"cuda"``).

    Call with a list of ``(x, edge_index[, edge_weight])`` numpy graphs;
    returns stacked float32 outputs ``[len(graphs), ...]`` in input order.
    """

    def __init__(self, apply_fn: Callable[[GraphBatch], torch.Tensor], *,
                 batch_size: int = 8, node_base: int = 64,
                 edge_base: int = 256, sort_edges: bool = False,
                 out_width: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self._apply = apply_fn
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.node_base = int(node_base)
        self.edge_base = int(edge_base)
        self.sort_edges = sort_edges
        self._seen_buckets: set = set()
        self._out_tail: tuple = (
            (int(out_width),) if out_width is not None else ())

    @property
    def num_compiled(self) -> int:
        """Distinct (pad_nodes, pad_edges, max_nodes) buckets served."""
        return len(self._seen_buckets)

    def _budget(self, graphs: Sequence) -> tuple:
        ns = [g[0].shape[0] for g in graphs]
        es = [g[1].shape[1] for g in graphs]
        pad_nodes = geometric_budget(sum(ns), self.node_base)
        pad_edges = geometric_budget(max(sum(es), 1), self.edge_base)
        max_nodes = geometric_budget(max(ns), self.node_base)
        return pad_nodes, pad_edges, max_nodes

    def __call__(self, graphs: Sequence) -> np.ndarray:
        """Traced as ``tgp.predict`` (``graphs``, ``chunks``) around each
        chunk's ``tgp.collate``, the model's spans and ``tgp.predict.d2h``,
        the wait for the card and the copy back."""
        B = self.batch_size
        if len(graphs) == 0:
            return np.empty((0,) + self._out_tail, dtype=np.float32)
        outs = []
        with tracing.span("tgp.predict") as sp:
            if sp:
                sp.set(graphs=len(graphs), chunks=-(-len(graphs) // B))
            for start in range(0, len(graphs), B):
                chunk = list(graphs[start: start + B])
                n_valid = len(chunk)
                while len(chunk) < B:  # keep B fixed; surplus sliced off
                    chunk.append(chunk[-1])
                pn, pe, mx = self._budget(chunk)
                self._seen_buckets.add((pn, pe, mx))
                batch = from_graphs(chunk, pad_nodes=pn, pad_edges=pe,
                                    max_nodes=mx, sort_edges=self.sort_edges,
                                    device=self.device)
                with torch.inference_mode():
                    out = self._apply(batch)
                with tracing.span("tgp.predict.d2h"):
                    out = out.to(torch.float32).cpu().numpy()
                self._out_tail = tuple(out.shape[1:])
                outs.append(out[:n_valid])
        return np.concatenate(outs, axis=0)
