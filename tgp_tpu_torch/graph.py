"""Static-shape graph batch containers (port of ``tgp_tpu/graph.py``).

* :class:`GraphBatch` — packed COO with trailing padding and validity
  masks: real nodes first, padding last; padding edges have sender =
  receiver = 0, weight 0 and ``edge_mask`` False.  With
  ``sort_edges=True`` the collator also builds static CSR metadata
  (receiver-sorted ``row_ptr``, the sender-sorted ``*_t`` layout,
  ``in_degree``), which the CUDA SpMM kernel reads.
* :class:`DenseGraphBatch` — ``[B, Nmax, ...]`` padded tensors.

Collation is host-side numpy, identical to ``tgp_tpu``'s; the result is
moved to ``device`` once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.segment import node_cells, segment_sum_ordered

__all__ = ["GraphBatch", "DenseGraphBatch", "from_graphs", "to_dense",
           "from_dense", "ceil_to"]

Tensor = torch.Tensor


def _move(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), Tensor)})


@dataclass(frozen=True)
class GraphBatch:
    """A padded, static-shape batch of graphs in packed COO layout.

    Field meanings follow ``tgp_tpu.graph.GraphBatch``: ``x [N, F]`` (zero
    on padding rows), ``senders``/``receivers [E]`` int32, ``edge_weight
    [E]`` (zero on padding edges), ``node_graph``/``node_pos [N]`` int32,
    ``node_mask [N]``/``edge_mask [E]`` bool, and the static ``num_graphs``,
    ``max_nodes``, ``edges_sorted`` and ``node_mask_shrunk`` flags.

    CSR metadata (``from_graphs(sort_edges=True)``): ``row_ptr
    [rows_pad+1]`` int32 receiver offsets (rows_pad = N rounded up to 256;
    zero-weight padding edges sit at the head of row 0 and are counted),
    the transpose layout ``senders_t``/``receivers_t``/``edge_weight_t``/
    ``row_ptr_t`` (edges sorted by sender, for the backward of the
    training slice), and ``in_degree [N]`` = Σ|w| of the edges into each
    node, self-loops included.

    ``has_self_loop [N]`` bool marks nodes with a valid ``(i, i)`` edge, so
    GCN's CSR path adds the unit self-loop only where none exists
    (``add_remaining_self_loops`` semantics).  Code that changes the edge
    set or shrinks the node mask must update it, and clear ``in_degree``.
    """

    x: Tensor
    senders: Tensor
    receivers: Tensor
    edge_weight: Tensor
    node_graph: Tensor
    node_pos: Tensor
    node_mask: Tensor
    edge_mask: Tensor
    num_graphs: int
    max_nodes: int
    edges_sorted: bool = False
    node_mask_shrunk: bool = False
    row_ptr: Optional[Tensor] = None
    senders_t: Optional[Tensor] = None
    receivers_t: Optional[Tensor] = None
    edge_weight_t: Optional[Tensor] = None
    row_ptr_t: Optional[Tensor] = None
    in_degree: Optional[Tensor] = None
    has_self_loop: Optional[Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def nodes_per_graph(self) -> Tensor:
        """``[B]`` int32 number of real nodes in each graph."""
        from tgp_tpu_torch.ops.segment import segment_count

        return segment_count(self.node_graph, self.num_graphs,
                             mask=self.node_mask)

    def edges_per_graph(self) -> Tensor:
        """``[B]`` int32 number of real edges in each graph."""
        from tgp_tpu_torch.ops.segment import segment_count

        return segment_count(self.edge_graph, self.num_graphs,
                             mask=self.edge_mask)

    @property
    def edge_graph(self) -> Tensor:
        """``[E]`` graph id of each edge (via its sender)."""
        return self.node_graph[self.senders.long()]

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def with_features(self, x: Tensor) -> "GraphBatch":
        return self.replace(x=x)

    def to(self, device: DeviceLike) -> "GraphBatch":
        return _move(self, torch.device(device))


@dataclass(frozen=True)
class DenseGraphBatch:
    """Dense padded batch: ``x [B,Nmax,F]``, ``adj [B,Nmax,Nmax]``,
    ``mask [B,Nmax]``."""

    x: Tensor
    adj: Tensor
    mask: Tensor

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.x.shape[1]

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "DenseGraphBatch":
        return dataclasses.replace(self, **kw)

    def with_features(self, x: Tensor) -> "DenseGraphBatch":
        return self.replace(x=x)

    def to(self, device: DeviceLike) -> "DenseGraphBatch":
        return _move(self, torch.device(device))


# ---------------------------------------------------------------------------
# Host-side collation (numpy)
# ---------------------------------------------------------------------------


def ceil_to(v: int, m: int) -> int:
    """Round ``v`` up to a multiple of ``m``."""
    return ((v + m - 1) // m) * m


def from_graphs(
    graphs: Sequence[tuple],
    *,
    pad_nodes: Optional[int] = None,
    pad_edges: Optional[int] = None,
    max_nodes: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    sort_edges: bool = False,
    dtype: Any = np.float32,
    device: DeviceLike = "cuda",
) -> GraphBatch:
    """Collate a list of ``(x, edge_index[, edge_weight])`` numpy graphs
    into a :class:`GraphBatch` on ``device`` (same packing, padding and CSR
    metadata as ``tgp_tpu.graph.from_graphs``).  Edge ids must lie in
    ``[0, n)`` of their graph: the CUDA kernels gather by them unchecked."""
    device = resolve_device(device)
    B = len(graphs)
    if B == 0:
        raise ValueError("from_graphs needs at least one graph")

    xs, eis, ews = [], [], []
    for g in graphs:
        if len(g) == 3:
            x, ei, ew = g
        else:
            x, ei = g
            ew = None
        x = np.asarray(x, dtype=dtype)
        if x.ndim == 1:
            x = x[:, None]
        ei = np.asarray(ei, dtype=np.int64).reshape(2, -1)
        if ei.size and (ei.min() < 0 or ei.max() >= x.shape[0]):
            raise ValueError(f"edge ids must lie in [0, {x.shape[0]}), got "
                             f"[{ei.min()}, {ei.max()}]")
        if ew is None:
            ew = np.ones(ei.shape[1], dtype=dtype)
        xs.append(x)
        eis.append(ei)
        ews.append(np.asarray(ew, dtype=dtype).reshape(-1))

    n_per = [x.shape[0] for x in xs]
    e_per = [ei.shape[1] for ei in eis]
    n_tot, e_tot = sum(n_per), sum(e_per)
    if max_nodes is None:
        max_nodes = max(n_per)
    elif max_nodes < max(n_per):
        raise ValueError(f"max_nodes={max_nodes} < largest graph ({max(n_per)})")
    N = pad_nodes if pad_nodes is not None else ceil_to(max(n_tot, 1), node_multiple)
    E = pad_edges if pad_edges is not None else ceil_to(max(e_tot, 1), edge_multiple)
    if N < n_tot or E < e_tot:
        raise ValueError(
            f"padding budget too small: need ({n_tot},{e_tot}), got ({N},{E})"
        )
    F = xs[0].shape[1]

    x_out = np.zeros((N, F), dtype=dtype)
    senders = np.zeros(E, dtype=np.int32)
    receivers = np.zeros(E, dtype=np.int32)
    edge_weight = np.zeros(E, dtype=dtype)
    node_graph = np.full(N, B - 1, dtype=np.int32)
    node_pos = np.zeros(N, dtype=np.int32)
    node_mask = np.zeros(N, dtype=bool)
    edge_mask = np.zeros(E, dtype=bool)

    n_off = e_off = 0
    for g, (x, ei, ew) in enumerate(zip(xs, eis, ews)):
        n, e = x.shape[0], ei.shape[1]
        x_out[n_off : n_off + n] = x
        node_graph[n_off : n_off + n] = g
        node_pos[n_off : n_off + n] = np.arange(n)
        node_mask[n_off : n_off + n] = True
        senders[e_off : e_off + e] = ei[0] + n_off
        receivers[e_off : e_off + e] = ei[1] + n_off
        edge_weight[e_off : e_off + e] = ew
        edge_mask[e_off : e_off + e] = True
        n_off += n
        e_off += e
    # padding nodes keep node_pos clamped into range for scatter safety
    node_pos[n_off:] = max_nodes - 1 if max_nodes > 0 else 0

    has_self_loop = np.zeros(N, dtype=bool)
    has_self_loop[senders[edge_mask & (senders == receivers)]] = True

    csr_aux = {}
    if sort_edges:
        order = np.argsort(receivers, kind="stable")
        senders, receivers = senders[order], receivers[order]
        edge_weight, edge_mask = edge_weight[order], edge_mask[order]
        rows_pad = ceil_to(max(N, 1), 256)
        counts = np.bincount(receivers, minlength=rows_pad)
        row_ptr = np.zeros(rows_pad + 1, np.int32)
        row_ptr[1:] = np.cumsum(counts).astype(np.int32)
        perm = np.argsort(senders, kind="stable")
        senders_t = senders[perm]
        counts_t = np.bincount(senders_t, minlength=rows_pad)
        row_ptr_t = np.zeros(rows_pad + 1, np.int32)
        row_ptr_t[1:] = np.cumsum(counts_t).astype(np.int32)
        in_degree = np.bincount(
            receivers, weights=np.abs(edge_weight), minlength=N
        )[:N].astype(dtype)
        csr_aux = dict(
            row_ptr=row_ptr,
            senders_t=senders_t,
            receivers_t=receivers[perm],
            edge_weight_t=edge_weight[perm],
            row_ptr_t=row_ptr_t,
            in_degree=in_degree,
        )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GraphBatch(
        x=dev(x_out),
        senders=dev(senders),
        receivers=dev(receivers),
        edge_weight=dev(edge_weight),
        node_graph=dev(node_graph),
        node_pos=dev(node_pos),
        node_mask=dev(node_mask),
        edge_mask=dev(edge_mask),
        num_graphs=B,
        max_nodes=max_nodes,
        edges_sorted=sort_edges,
        has_self_loop=dev(has_self_loop),
        **{k: dev(v) for k, v in csr_aux.items()},
    )


# ---------------------------------------------------------------------------
# Sparse <-> dense conversion
# ---------------------------------------------------------------------------


def to_dense(batch: GraphBatch, max_nodes: Optional[int] = None
             ) -> DenseGraphBatch:
    """Sparse packed batch → dense padded batch, the same bits every run.
    Each valid node owns its cell ``(graph, position)``, so the features
    and the mask are plain indexed writes (masked nodes write to a spare
    cell past the end).  Duplicate edges are summed in a fixed order: the
    edges sorted stably by their flat cell, each run of one cell summed by
    :func:`~tgp_tpu_torch.ops.segment.segment_sum_ordered` (K4 on the
    card), and every position writes its run's sum to the cell."""
    Nmax = max_nodes if max_nodes is not None else batch.max_nodes
    B, F = batch.num_graphs, batch.num_features
    dev = batch.device
    nm = batch.node_mask
    spare = B * Nmax
    cell = torch.where(nm, node_cells(batch.node_graph, batch.node_pos, Nmax),
                       spare)
    x_safe = torch.where(nm[:, None], batch.x, 0.0)
    x_dense = batch.x.new_zeros(spare + 1, F).index_put((cell,), x_safe)
    hits = torch.zeros(spare + 1, dtype=torch.bool, device=dev).index_put_(
        (cell,), torch.ones((), dtype=torch.bool, device=dev))

    s, r = batch.senders.long(), batch.receivers.long()
    pos = batch.node_pos.long()
    n_cells = B * Nmax * Nmax
    slot = (batch.node_graph[s].long() * Nmax + pos[s]) * Nmax + pos[r]
    key, order = torch.sort(torch.where(batch.edge_mask, slot, n_cells),
                            stable=True)
    is_head = torch.ones_like(key, dtype=torch.bool)
    is_head[1:] = key[1:] != key[:-1]
    run_id = torch.cumsum(is_head, 0) - 1
    w = torch.where(batch.edge_mask, batch.edge_weight, 0.0)[order]
    run_sum = segment_sum_ordered(w, run_id, w.shape[0], ids_sorted=True)
    adj = w.new_zeros(n_cells + 1).index_put_((key,), run_sum[run_id])
    return DenseGraphBatch(x=x_dense[:spare].view(B, Nmax, F),
                           adj=adj[:n_cells].view(B, Nmax, Nmax),
                           mask=hits[:spare].view(B, Nmax))


def from_dense(dense: DenseGraphBatch, *, keep_self_loops: bool = True
               ) -> GraphBatch:
    """Dense padded batch → sparse packed batch (block-diagonal flatten):
    every node slot becomes a node, every adjacency entry an edge slot,
    masked by nonzero weight and endpoint validity."""
    B, K, F = dense.x.shape
    N = B * K
    dev = dense.x.device
    x = dense.x.reshape(N, F)
    mask = dense.mask.reshape(N)
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    node_graph = torch.arange(B, dtype=torch.int32,
                              device=dev).repeat_interleave(K)
    node_pos = ar.repeat(B)
    goff = (torch.arange(B, dtype=torch.int32, device=dev) * K)[:, None, None]
    senders = (ar[None, :, None] + goff).expand(B, K, K).reshape(-1)
    receivers = (ar[None, None, :] + goff).expand(B, K, K).reshape(-1)
    w = dense.adj.reshape(-1)
    valid = (w != 0) & mask[senders.long()] & mask[receivers.long()]
    if not keep_self_loops:
        valid = valid & (senders != receivers)
    w = torch.where(valid, w, 0.0)
    senders = torch.where(valid, senders, 0)
    receivers = torch.where(valid, receivers, 0)
    return GraphBatch(
        x=torch.where(mask[:, None], x, 0.0),
        senders=senders,
        receivers=receivers,
        edge_weight=w,
        node_graph=node_graph,
        node_pos=node_pos,
        node_mask=mask,
        edge_mask=valid,
        num_graphs=B,
        max_nodes=K,
    )
