"""Host-side graph transforms (port of ``tgp_tpu/data/transforms.py``).

They run in the data pipeline, in numpy, on raw ``(x, edge_index[,
edge_weight][, y])`` graph tuples, and return numpy tuples of the same
form as the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["NormalizeAdj", "SortNodes", "split_graph_tuple"]


def split_graph_tuple(graph):
    """Parse a positional graph tuple ``(x, ei[, ew][, y])`` into ``(x, ei,
    ew, y)``, ``ew``/``y`` possibly None.  An explicit None may fill the
    weight slot; a 1-D *integer* array of length N in slot 2 of a 3-tuple
    is node labels (``(x, ei, y)``), and when N == E that is ambiguous with
    integer edge weights, so it raises and asks for ``(x, ei, None, y)`` or
    float weights."""
    x, ei = np.asarray(graph[0]), np.asarray(graph[1])
    ew = graph[2] if len(graph) > 2 else None
    y = graph[3] if len(graph) > 3 else None
    if ew is not None:
        ew = np.asarray(ew)
        looks_like_labels = (y is None and ew.ndim == 1
                             and ew.shape[0] == x.shape[0]
                             and np.issubdtype(ew.dtype, np.integer))
        if looks_like_labels and ew.shape[0] == ei.shape[1]:
            raise ValueError(
                "ambiguous graph tuple: slot 2 is a 1-D integer array and "
                f"N == E == {ew.shape[0]} — it could be node labels or "
                "integer edge weights.  Pass the explicit 4-tuple "
                "(x, ei, None, y) for labels or (x, ei, ew) with float "
                "edge weights.")
        if looks_like_labels:
            y, ew = ew, None
    if y is not None:
        y = np.asarray(y)
    return x, ei, ew, y


def _coalesce(edge_index, edge_weight, num_nodes):
    """Merge duplicate edges, summing their weights; edges come out sorted
    by ``(sender, receiver)``."""
    key = edge_index[0].astype(np.int64) * num_nodes + edge_index[1]
    order = np.argsort(key, kind="stable")
    key, w = key[order], edge_weight[order]
    uniq, first = np.unique(key, return_index=True)
    sums = np.add.reduceat(w, first)
    ei = np.stack([uniq // num_nodes, uniq % num_nodes])
    return ei.astype(np.int64), sums


@dataclass
class NormalizeAdj:
    """``A → (1−δ)·I + δ·D^{-1/2} A D^{-1/2}`` (= ``I − δ·L_sym``), existing
    self-loops merged into the diagonal; trailing node labels pass
    through."""

    delta: float = 0.85
    add_self_loops: bool = True

    def __call__(self, graph):
        x, ei, ew, y = split_graph_tuple(graph)
        if ew is None:
            ew = np.ones(ei.shape[1])
        ew = np.asarray(ew, np.float64)
        n = x.shape[0]
        deg = np.zeros(n)
        np.add.at(deg, ei[1], ew)
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        w_norm = self.delta * ew * dinv[ei[0]] * dinv[ei[1]]
        loops = np.arange(n)
        ei_out = np.concatenate([ei, np.stack([loops, loops])], axis=1)
        w_out = np.concatenate([w_norm, np.full(n, 1.0 - self.delta)])
        ei_final, sums = _coalesce(ei_out, w_out, n)
        out = (x, ei_final.astype(ei.dtype), sums.astype(np.float32))
        return out + ((y,) if y is not None else ())


@dataclass
class SortNodes:
    """Sort nodes by label (stable), remapping ``edge_index``; edge order,
    and so ``ew``, is unchanged.  Takes ``(x, ei, y)``, ``(x, ei, ew, y)``
    or ``(x, ei, None, y)``."""

    descending: bool = False

    def __call__(self, graph):
        x, ei, ew, y = split_graph_tuple(graph)
        if y is None:
            raise ValueError("SortNodes needs node labels y")
        order = np.argsort(-y if self.descending else y, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        x2, y2 = x[order], y[order]
        ei2 = inv[ei]
        if ew is not None:
            return (x2, ei2, ew, y2)
        return (x2, ei2, y2)
