"""Static-shape graph batch containers (port of ``tgp_tpu/graph.py``).

* :class:`GraphBatch` — packed COO with trailing padding and validity
  masks: real nodes first, padding last; padding edges have sender =
  receiver = 0, weight 0 and ``edge_mask`` False.  With
  ``sort_edges=True`` the collator also builds static CSR metadata
  (receiver-sorted ``row_ptr``, the sender-sorted ``*_t`` layout,
  ``in_degree``), which the CUDA SpMM kernel reads.
* :class:`DenseGraphBatch` — ``[B, Nmax, ...]`` padded tensors.

Packing is host-side numpy, identical to ``tgp_tpu``'s, and its arrays
are copied to ``device`` once; the CSR metadata is built after the copy,
by tensor ops on ``device``, with the same bits as ``tgp_tpu``'s.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tgp_tpu_torch import tracing
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.segment import node_cells, segment_sum

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

    CSR metadata (``from_graphs(sort_edges=True)``, built on the batch's
    device after the packed arrays are copied there): ``row_ptr
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
# Collation: host-side packing (numpy), the CSR layout on the device
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
    ``[0, n)`` of their graph: the CUDA kernels gather by them unchecked.

    Traced as ``tgp.collate`` around ``tgp.collate.pack``,
    ``tgp.collate.h2d`` (``bytes`` copied, ``pad_bytes`` of them padding)
    and, with ``sort_edges``, ``tgp.collate.csr`` after the copy
    (``on_card``: built on a CUDA device; ``edges``: the edge slots
    sorted)."""
    device = resolve_device(device)
    if len(graphs) == 0:
        raise ValueError("from_graphs needs at least one graph")
    with tracing.span("tgp.collate"):
        with tracing.span("tgp.collate.pack"):
            host, n_tot, e_tot, max_nodes = _pack(
                graphs, pad_nodes, pad_edges, max_nodes, node_multiple,
                edge_multiple, dtype)
        N, E = host["x"].shape[0], host["senders"].shape[0]
        with tracing.span("tgp.collate.h2d") as h2d:
            moved = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for k, a in host.items()}
            if h2d:
                h2d.set(**_copied_bytes(host, n_tot, N, e_tot, E))
        if sort_edges:
            with tracing.span("tgp.collate.csr") as csr:
                _csr_layout(moved, e_tot)
                if csr:
                    csr.set(on_card=device.type == "cuda", edges=E)
    return GraphBatch(num_graphs=len(graphs), max_nodes=max_nodes,
                      edges_sorted=sort_edges, **moved)


def _pack(graphs, pad_nodes, pad_edges, max_nodes, node_multiple,
          edge_multiple, dtype):
    """The graphs checked and copied into padded numpy arrays, with the
    self-loop marks; also the real node and edge counts and
    ``max_nodes``."""
    B = len(graphs)
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
    host = dict(x=x_out, senders=senders, receivers=receivers,
                edge_weight=edge_weight, node_graph=node_graph,
                node_pos=node_pos, node_mask=node_mask, edge_mask=edge_mask,
                has_self_loop=has_self_loop)
    return host, n_tot, e_tot, max_nodes


def _csr_layout(t: dict, e_real: int) -> None:
    """Sort the edges of the copied arrays ``t`` (the first ``e_real``
    real, the rest padding) by receiver, in place, and add the CSR
    metadata: ``row_ptr``, the sender-sorted transpose layout and
    ``in_degree``.  Tensor ops on the arrays' own device that read
    nothing back to the host, with ``tgp_tpu``'s bits on any device: both
    sorts are stable, so every integer array has one answer; the offsets
    are ``searchsorted`` of each row id in the sorted keys; ``in_degree``
    adds each row's |w| in f64 one after another, in edge order (one thread
    a row on the card, no atomics), as numpy's ``bincount`` does, and
    rounds the sum to the weights' dtype."""
    N, E = t["x"].shape[0], t["receivers"].shape[0]
    receivers, order = torch.sort(t["receivers"], stable=True)
    senders, edge_weight, edge_mask = (
        t[k].index_select(0, order)
        for k in ("senders", "edge_weight", "edge_mask"))
    rows = torch.arange(ceil_to(max(N, 1), 256) + 1, dtype=torch.int32,
                        device=receivers.device)
    row_ptr = torch.searchsorted(receivers, rows, out_int32=True)
    senders_t, perm = torch.sort(senders, stable=True)
    # [E, 1] data: each row added in edge order on the card too (1-D data
    # takes another order there); unsafe: no check reads the offsets back.
    # The padding edges, zeros that end row 0 (the stable sort keeps them
    # after its real edges) and leave its sum's bits alone, are cut into
    # segments of their own of at most 256, so no thread walks them all.
    pad_starts = row_ptr[1:2] - (E - e_real) + torch.arange(
        0, E - e_real, 256, dtype=torch.int32, device=rows.device)
    sums = torch.segment_reduce(
        edge_weight.abs().to(torch.float64)[:, None], "sum",
        offsets=torch.cat([row_ptr[:1], pad_starts, row_ptr[1:N + 1]]),
        unsafe=True)[:, 0]
    in_degree = torch.cat([sums[:1], sums[1 + pad_starts.shape[0]:]])[:N]
    t.update(
        senders=senders,
        receivers=receivers,
        edge_weight=edge_weight,
        edge_mask=edge_mask,
        row_ptr=row_ptr,
        senders_t=senders_t,
        receivers_t=receivers.index_select(0, perm),
        edge_weight_t=edge_weight.index_select(0, perm),
        row_ptr_t=torch.searchsorted(senders_t, rows, out_int32=True),
        in_degree=in_degree.to(edge_weight.dtype),
    )


#: the copied arrays by what their first axis indexes: node slots or edge
#: slots
_NODE_ARRAYS = ("x", "node_graph", "node_pos", "node_mask", "has_self_loop")
_EDGE_ARRAYS = ("senders", "receivers", "edge_weight", "edge_mask")


def _copied_bytes(host: dict, n_real: int, n_pad: int, e_real: int,
                  e_pad: int) -> dict:
    """Bytes copied to the device, and the part of them that pads: each
    node-indexed array's share of padded node slots, each edge-indexed
    array's share of padded edge slots.  An array of neither kind raises,
    so a new one is classified before it is counted."""
    pad = 0
    for k, a in host.items():
        if k in _NODE_ARRAYS:
            real, slots = n_real, n_pad
        elif k in _EDGE_ARRAYS:
            real, slots = e_real, e_pad
        else:
            raise KeyError(f"collated array {k!r} is not classified as "
                           "node- or edge-indexed")
        if a.shape[0] != slots:
            raise ValueError(f"collated array {k!r} has {a.shape[0]} rows, "
                             f"not {slots} slots")
        pad += a.nbytes // slots * (slots - real) if slots else 0
    return dict(bytes=sum(a.nbytes for a in host.values()), pad_bytes=pad)


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
    :func:`~tgp_tpu_torch.ops.segment.segment_sum` (K4 on the
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
    run_sum = segment_sum(w, run_id, w.shape[0], ids_sorted=True)
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
