"""Batching (port of ``tgp_tpu/data/loaders.py``): a list of numpy graphs
→ a stream of :class:`~tgp_tpu_torch.graph.GraphBatch` on ``device``.

Padding budgets are fixed over the dataset (the worst-case batch, rounded
up), so every batch has the same shapes and, with ``sort_edges``, the
same CSR row count; the JAX package needs that for one compiled program,
the port keeps it so both packages see the same batches.  Shuffling draws
from ``numpy.random.default_rng(seed)`` as the JAX loaders do: the same
seed gives the same graphs in the same order.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.graph import ceil_to, from_graphs
from tgp_tpu_torch.ops.sparse import use_kernel_spmm

__all__ = ["GraphLoader", "BucketedGraphLoader", "compute_budgets",
           "worst_case_cycled"]


def worst_case_cycled(per: Sequence[int], batch_size: int) -> int:
    """Worst-case total of ``batch_size`` draws from ``per``, where a
    dataset shorter than a batch pads it by cycling the graph list (each
    item up to ``ceil(B/L)`` times)."""
    per = sorted(per, reverse=True)
    L = len(per)
    if batch_size >= L:
        reps, rem = divmod(batch_size, L)
        return reps * sum(per) + sum(per[:rem])
    return sum(per[:batch_size])


def _auto_sort_edges(sort_edges: Optional[bool], pad_edges: int,
                     device: torch.device) -> bool:
    """``None`` (auto) collates receiver-sorted batches with CSR metadata
    exactly where the CSR kernel (K1) engages on them
    (:func:`~tgp_tpu_torch.ops.sparse.use_kernel_spmm`: an edge budget of
    at least ``PALLAS_MIN_EDGES``, on CUDA); elsewhere the host-side sort
    buys nothing."""
    if sort_edges is not None:
        return sort_edges
    return use_kernel_spmm(pad_edges, True, device)


def compute_budgets(graphs: Sequence, batch_size: int,
                    node_multiple: int = 8, edge_multiple: int = 128
                    ) -> Tuple[int, int, int]:
    """Worst-case ``(pad_nodes, pad_edges, max_nodes_per_graph)`` of any
    ``batch_size``-sized batch of ``graphs``."""
    n_per = sorted((g[0].shape[0] for g in graphs), reverse=True)
    e_per = sorted((g[1].shape[1] for g in graphs), reverse=True)
    pad_nodes = ceil_to(worst_case_cycled(n_per, batch_size), node_multiple)
    pad_edges = ceil_to(max(worst_case_cycled(e_per, batch_size), 1),
                        edge_multiple)
    return pad_nodes, pad_edges, n_per[0]


class GraphLoader:
    """Minibatch iterator with static padding budgets.

    Args:
      graphs: ``(x, edge_index[, edge_weight])`` numpy graphs.
      labels: optional per-graph labels, yielded (as numpy) with each
        batch.
      batch_size: graphs per batch; a short last batch is padded by
        cycling the order, so every batch holds ``batch_size`` graphs.
      sort_edges: ``None`` sorts where the CSR kernel engages (see
        :func:`_auto_sort_edges`).
      device: where batches go (default ``"cuda"``).
    """

    def __init__(self, graphs: Sequence, labels: Optional[np.ndarray] = None,
                 batch_size: int = 32, shuffle: bool = False, seed: int = 0,
                 pad_nodes: Optional[int] = None,
                 pad_edges: Optional[int] = None,
                 max_nodes: Optional[int] = None,
                 sort_edges: Optional[bool] = None, *,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.graphs = list(graphs)
        self.labels = None if labels is None else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        pn, pe, mx = compute_budgets(self.graphs, batch_size)
        self.pad_nodes = pad_nodes or pn
        self.pad_edges = pad_edges or pe
        self.max_nodes = max_nodes or mx
        self.sort_edges = _auto_sort_edges(sort_edges, self.pad_edges,
                                           self.device)

    def __len__(self) -> int:
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _iter_with_indices(self) -> Iterator:
        """``(batch, labels or None, graph indices)`` for each batch; the
        indices tell which graphs a cycled last batch repeats."""
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(order)
        B = self.batch_size
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            if len(idx) < B:
                idx = np.take(order, np.arange(start, start + B),
                              mode="wrap")
            batch = from_graphs(
                [self.graphs[i] for i in idx],
                pad_nodes=self.pad_nodes, pad_edges=self.pad_edges,
                max_nodes=self.max_nodes, sort_edges=self.sort_edges,
                device=self.device)
            y = None if self.labels is None else np.asarray(self.labels[idx])
            yield batch, y, idx

    def __iter__(self) -> Iterator:
        for batch, y, _ in self._iter_with_indices():
            if y is not None:
                yield batch, y
            else:
                yield batch


class BucketedGraphLoader:
    """Size-bucketed minibatch iterator: graphs sorted by node count into
    ``num_buckets`` quantile buckets, batches drawn within a bucket, each
    bucket with its own budget (:attr:`budgets`); buckets with equal
    budgets merge and are budgeted again over their union.  Yields what
    :class:`GraphLoader` yields; with ``shuffle`` the batch order mixes
    buckets."""

    def __init__(self, graphs: Sequence, labels: Optional[np.ndarray] = None,
                 batch_size: int = 32, num_buckets: int = 4,
                 shuffle: bool = False, seed: int = 0,
                 sort_edges: Optional[bool] = None, *,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._sort_edges_arg = sort_edges
        self.graphs = list(graphs)
        self.labels = None if labels is None else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

        sizes = np.array([g[0].shape[0] for g in self.graphs])
        order = np.argsort(sizes, kind="stable")
        num_buckets = max(1, min(num_buckets, len(order)))
        splits = np.array_split(order, num_buckets)
        self.buckets: List[np.ndarray] = []
        self.budgets: List[Tuple[int, int, int]] = []
        for part in splits:
            if len(part) == 0:
                continue
            budget = compute_budgets([self.graphs[i] for i in part],
                                     batch_size)
            if self.budgets and budget == self.budgets[-1]:
                # equal budgets of two parts do not bound a batch mixing
                # both parts' edge-heavy graphs: budget the union again
                merged = np.concatenate([self.buckets[-1], part])
                self.buckets[-1] = merged
                self.budgets[-1] = compute_budgets(
                    [self.graphs[i] for i in merged], batch_size)
            else:
                self.buckets.append(part)
                self.budgets.append(budget)

    def __len__(self) -> int:
        B = self.batch_size
        return sum((len(b) + B - 1) // B for b in self.buckets)

    def __iter__(self) -> Iterator:
        B = self.batch_size
        chunks = []  # (bucket id, graph indices) of each batch
        for bi, bucket in enumerate(self.buckets):
            idx = bucket.copy()
            if self.shuffle:
                self.rng.shuffle(idx)
            for start in range(0, len(idx), B):
                sel = idx[start : start + B]
                if len(sel) < B:
                    sel = np.take(idx, np.arange(start, start + B),
                                  mode="wrap")
                chunks.append((bi, sel))
        if self.shuffle:
            self.rng.shuffle(chunks)
        for bi, sel in chunks:
            pn, pe, mx = self.budgets[bi]
            batch = from_graphs(
                [self.graphs[i] for i in sel], pad_nodes=pn, pad_edges=pe,
                max_nodes=mx, sort_edges=_auto_sort_edges(
                    self._sort_edges_arg, pe, self.device),
                device=self.device)
            if self.labels is not None:
                yield batch, np.asarray(self.labels[sel])
            else:
                yield batch
