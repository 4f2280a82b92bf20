"""Static-shape graph batch containers (port of ``tgp_tpu/graph.py``).

* :class:`GraphBatch` — packed COO with trailing padding and validity
  masks: real nodes first, padding last; padding edges have sender =
  receiver = 0, weight 0 and ``edge_mask`` False.  With
  ``sort_edges=True`` the collator also builds static CSR metadata
  (receiver-sorted ``row_ptr``, the sender-sorted ``*_t`` layout,
  ``in_degree``), which the CUDA SpMM kernel reads.
* :class:`DenseGraphBatch` — ``[B, Nmax, ...]`` padded tensors.

Collation writes only a batch's real rows on the host (through
page-locked staging and one asynchronous copy each on a CUDA device) and
builds the padding, the masks, the per-node graph ids and positions, the
self-loop marks and the CSR metadata by tensor ops on ``device``: the
same bits as ``tgp_tpu``'s host packing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from tgp_tpu_torch import tracing
from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.ops.kernels.segment_spmm import csr_layouts
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
# Collation: the real rows from the host, the rest built on the device
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

    Only the real rows are written on the host: ``x``, the offset
    ``senders``/``receivers``, the weights if any graph has them, and the
    graphs' node offsets.  On a CUDA device they are written into one
    page-locked staging tensor and copied asynchronously into the padded
    device arrays; on the CPU, straight into those arrays.  The padding
    and the arrays fixed by the graphs' sizes are then built on the
    device (:func:`_fill`).

    Traced as ``tgp.collate`` around ``tgp.collate.pack`` (the checks and
    the host writes), ``tgp.collate.h2d`` (the copies and the fills;
    ``bytes`` of real rows staged, ``pad_bytes`` 0: the stage holds no
    padding; ``staged``: through page-locked memory) and, with
    ``sort_edges``,
    ``tgp.collate.csr`` (``on_card``: built on a CUDA device; ``edges``:
    the edge slots sorted)."""
    device = resolve_device(device)
    if len(graphs) == 0:
        raise ValueError("from_graphs needs at least one graph")
    B = len(graphs)
    with tracing.span("tgp.collate"):
        with tracing.span("tgp.collate.pack"):
            xs, eis, ews = _checked(graphs, dtype)
            n_per = [x.shape[0] for x in xs]
            n_tot, e_tot = sum(n_per), sum(ei.shape[1] for ei in eis)
            if max_nodes is None:
                max_nodes = max(n_per)
            elif max_nodes < max(n_per):
                raise ValueError(
                    f"max_nodes={max_nodes} < largest graph ({max(n_per)})")
            N = pad_nodes if pad_nodes is not None else ceil_to(
                max(n_tot, 1), node_multiple)
            E = pad_edges if pad_edges is not None else ceil_to(
                max(e_tot, 1), edge_multiple)
            if N < n_tot or E < e_tot:
                raise ValueError(f"padding budget too small: need ({n_tot},"
                                 f"{e_tot}), got ({N},{E})")
            floats = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
            t = dict(x=((N, xs[0].shape[1]), floats),
                     senders=((E,), torch.int32),
                     receivers=((E,), torch.int32),
                     edge_weight=((E,), floats),
                     node_offsets=((B + 1,), torch.int32))
            t = {k: torch.empty(s, dtype=d, device=device)
                 for k, (s, d) in t.items()}
            weighted = any(ew is not None for ew in ews)
            staged = device.type == "cuda"
            real = _real_rows(t, dict(x=n_tot, senders=e_tot,
                                      receivers=e_tot, node_offsets=B + 1,
                                      **({"edge_weight": e_tot}
                                         if weighted else {})), staged)
            _write(real, xs, eis, ews)
        with tracing.span("tgp.collate.h2d") as h2d:
            if staged:
                for k, a in real.items():
                    t[k][:a.shape[0]].copy_(a, non_blocking=True)
            _fill(t, n_tot, e_tot, max_nodes, weighted)
            if h2d:
                # the stage holds real rows only (_real_rows): none pads
                h2d.set(staged=staged, pad_bytes=0,
                        bytes=sum(a.nbytes for a in real.values()))
        if sort_edges:
            with tracing.span("tgp.collate.csr") as csr:
                _csr_layout(t, e_tot)
                if csr:
                    csr.set(on_card=device.type == "cuda", edges=E)
    return GraphBatch(num_graphs=B, max_nodes=max_nodes,
                      edges_sorted=sort_edges, **t)


def _checked(graphs, dtype):
    """Each graph's ``x`` (2-D, in ``dtype``), ``edge_index`` (``[2, e]``
    int64, ids checked) and weights (flat, in ``dtype``; None where the
    graph has none)."""
    xs, eis, ews = [], [], []
    for g in graphs:
        x, ei, ew = g if len(g) == 3 else (*g, None)
        x = np.asarray(x, dtype=dtype)
        if x.ndim == 1:
            x = x[:, None]
        ei = np.asarray(ei, dtype=np.int64).reshape(2, -1)
        # one pass: as unsigned, a negative id reads 2**63 or more
        if ei.size and ei.view(np.uint64).max() >= x.shape[0]:
            raise ValueError(f"edge ids must lie in [0, {x.shape[0]}), got "
                             f"[{ei.min()}, {ei.max()}]")
        xs.append(x)
        eis.append(ei)
        ews.append(None if ew is None
                   else np.asarray(ew, dtype=dtype).reshape(-1))
    return xs, eis, ews


def _real_rows(t: dict, rows: dict, staged: bool) -> dict:
    """Host tensors for the first ``rows[k]`` rows of each array ``t[k]``:
    views of one page-locked tensor from PyTorch's caching host allocator
    (``staged``), else the arrays' own rows.  Each array's stretch of the
    stage starts 256-byte aligned and is sized for all its rows, so every
    batch of a bucket asks the allocator for the same block.  The
    allocator records an event for the non-blocking copy out of the
    block and hands the block out again only after that event, so a later
    batch never writes over bytes still being copied."""
    if not staged:
        return {k: t[k][:r] for k, r in rows.items()}
    starts, size = {}, 0
    for k in rows:
        starts[k] = size
        size += ceil_to(t[k].nbytes, 256)
    stage = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    return {k: stage[starts[k]:starts[k] + t[k][:r].nbytes].view(
                t[k].dtype).view(t[k][:r].shape) for k, r in rows.items()}


def _write(real: dict, xs, eis, ews) -> None:
    """The graphs' real rows written in one pass each through the numpy
    views of the host tensors ``real``: ``x``, the ids plus their graph's
    node offset (int32, no int64 temporary), the weights (ones for a graph
    without) where staged, and the ``B + 1`` node offsets.  Numpy's copies
    run on the calling thread: torch's CPU copies split them over its
    intra-op threads, which made requests of small graphs slower on a
    shared host."""
    x, senders, receivers, offsets = (
        real[k].numpy() for k in ("x", "senders", "receivers",
                                  "node_offsets"))
    w = real["edge_weight"].numpy() if "edge_weight" in real else None
    n_off = e_off = 0
    offsets[0] = 0
    for g, (xg, ei, ew) in enumerate(zip(xs, eis, ews)):
        n, e = xg.shape[0], ei.shape[1]
        x[n_off:n_off + n] = xg
        for ids, out in ((ei[0], senders), (ei[1], receivers)):
            np.add(ids, n_off, out=out[e_off:e_off + e], casting="unsafe")
        if w is not None:
            w[e_off:e_off + e] = 1 if ew is None else ew
        n_off += n
        e_off += e
        offsets[g + 1] = n_off


def _fill(t: dict, n_real: int, e_real: int, max_nodes: int,
          weighted: bool) -> None:
    """Complete the arrays ``t`` on their own device, whose first
    ``n_real`` node and ``e_real`` edge rows are written, with the
    padding and the arrays fixed by the graphs' node offsets (popped from
    ``t``): tensor ops that read nothing back to the host.  Padding rows
    of ``x``, ``senders``, ``receivers`` and ``edge_weight`` are 0, and
    real weights 1 where no graph has any; ``node_graph`` counts the
    graphs that end at or before a node (``B - 1`` on padding),
    ``node_pos`` is a node's index in its graph (``max_nodes - 1`` on
    padding); ``has_self_loop`` is an indexed write at the senders of
    valid ``(i, i)`` edges, the other edges writing a spare slot."""
    offsets = t.pop("node_offsets")
    x, senders, receivers = t["x"], t["senders"], t["receivers"]
    N, E, dev = x.shape[0], senders.shape[0], x.device
    x[n_real:].zero_()
    for k in ("senders", "receivers", "edge_weight"):
        t[k][e_real:].zero_()
    if not weighted:
        t["edge_weight"][:e_real].fill_(1)
    nodes = torch.arange(N, dtype=torch.int32, device=dev)
    node_mask = nodes < n_real
    node_graph = torch.searchsorted(offsets[1:], nodes, right=True,
                                    out_int32=True).clamp_(
                                        max=offsets.shape[0] - 2)
    node_pos = torch.where(node_mask,
                           nodes - offsets.index_select(0, node_graph),
                           max(max_nodes - 1, 0))
    edge_mask = torch.arange(E, dtype=torch.int32, device=dev) < e_real
    loops = torch.where(edge_mask & (senders == receivers), senders, N)
    has_self_loop = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    has_self_loop.index_fill_(0, loops.long(), True)
    t.update(node_graph=node_graph, node_pos=node_pos, node_mask=node_mask,
             edge_mask=edge_mask, has_self_loop=has_self_loop[:N])


def _csr_layout(t: dict, e_real: int) -> None:
    """Sort the edges of the copied arrays ``t`` (the first ``e_real``
    real, the rest padding) by receiver, in place, and add the CSR
    metadata: ``row_ptr``, the sender-sorted transpose layout (both from
    :func:`~tgp_tpu_torch.ops.kernels.segment_spmm.csr_layouts`, rows
    padded to 256 on both sides) and ``in_degree``.  Tensor ops on the
    arrays' own device that read nothing back to the host, with
    ``tgp_tpu``'s bits on any device: ``in_degree`` adds each row's |w| in
    f64 one after another, in edge order (one thread a row on the card,
    no atomics), as numpy's ``bincount`` does, and rounds the sum to the
    weights' dtype."""
    N, E = t["x"].shape[0], t["receivers"].shape[0]
    rows = ceil_to(max(N, 1), 256)
    csr = csr_layouts(t["senders"], t["receivers"], rows, rows)
    edge_weight, edge_mask = (t[k].index_select(0, csr.order)
                              for k in ("edge_weight", "edge_mask"))
    row_ptr = csr.row_ptr
    # [E, 1] data: each row added in edge order on the card too (1-D data
    # takes another order there); unsafe: no check reads the offsets back.
    # The padding edges, zeros that end row 0 (the stable sort keeps them
    # after its real edges) and leave its sum's bits alone, are cut into
    # segments of their own of at most 256, so no thread walks them all.
    pad_starts = row_ptr[1:2] - (E - e_real) + torch.arange(
        0, E - e_real, 256, dtype=torch.int32, device=row_ptr.device)
    sums = torch.segment_reduce(
        edge_weight.abs().to(torch.float64)[:, None], "sum",
        offsets=torch.cat([row_ptr[:1], pad_starts, row_ptr[1:N + 1]]),
        unsafe=True)[:, 0]
    in_degree = torch.cat([sums[:1], sums[1 + pad_starts.shape[0]:]])[:N]
    t.update(
        senders=csr.senders,
        receivers=csr.receivers,
        edge_weight=edge_weight,
        edge_mask=edge_mask,
        row_ptr=row_ptr,
        senders_t=csr.senders_t,
        receivers_t=csr.receivers_t,
        edge_weight_t=edge_weight.index_select(0, csr.perm),
        row_ptr_t=csr.row_ptr_t,
        in_degree=in_degree.to(edge_weight.dtype),
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
