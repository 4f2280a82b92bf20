"""The oracle of ``tgp_tpu_torch.graph.from_graphs``: its earlier path, the
graphs packed into padded numpy arrays on the host, every array copied to
the device whole, and the CSR layout built after the copy.  Collation has
one right answer, so the tests hold the port's collated arrays (and the
logits of a model fed them) to this path's, bit for bit.

Imports numpy, torch and the port only (no JAX), so the CUDA tests use it
too.  Test files import it by its own name (``import collate_oracle``),
from the directory pytest puts on the path: an installed package named
``tests`` would shadow ``tests.collate_oracle``.
"""

import numpy as np
import torch

from tgp_tpu_torch.graph import GraphBatch, _csr_layout, ceil_to


def pack(graphs, pad_nodes, pad_edges, max_nodes, node_multiple,
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


def csr_oracle(host: dict) -> dict:
    """The receiver-sorted CSR layout of packed numpy arrays by numpy's
    arithmetic (two stable argsorts, bincounts, an f64 weighted bincount
    rounded to the weights' dtype): the oracle of the tensor build."""
    N = host["x"].shape[0]
    order = np.argsort(host["receivers"], kind="stable")
    out = {k: host[k][order]
           for k in ("senders", "receivers", "edge_weight", "edge_mask")}
    s, r, w = out["senders"], out["receivers"], out["edge_weight"]
    rows_pad = ceil_to(max(N, 1), 256)
    perm = np.argsort(s, kind="stable")
    row_ptr = np.zeros(rows_pad + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(r, minlength=rows_pad))
    row_ptr_t = np.zeros(rows_pad + 1, np.int32)
    row_ptr_t[1:] = np.cumsum(np.bincount(s[perm], minlength=rows_pad))
    out.update(row_ptr=row_ptr, senders_t=s[perm], receivers_t=r[perm],
               edge_weight_t=w[perm], row_ptr_t=row_ptr_t,
               in_degree=np.bincount(r, weights=np.abs(w), minlength=N)[
                   :N].astype(w.dtype))
    return out


def from_graphs(graphs, *, pad_nodes=None, pad_edges=None, max_nodes=None,
                node_multiple=8, edge_multiple=128, sort_edges=False,
                dtype=np.float32, device="cuda") -> GraphBatch:
    """The batch by the oracle's path: :func:`pack`, each padded array
    copied to ``device``, then (``sort_edges``) the CSR layout built
    there."""
    host, _, e_tot, max_nodes = pack(graphs, pad_nodes, pad_edges, max_nodes,
                                     node_multiple, edge_multiple, dtype)
    moved = {k: torch.from_numpy(a).to(device) for k, a in host.items()}
    if sort_edges:
        _csr_layout(moved, e_tot)
    return GraphBatch(num_graphs=len(graphs), max_nodes=max_nodes,
                      edges_sorted=sort_edges, **moved)


#: every array of a collated batch, the CSR layout last
BATCH_ARRAYS = ("x", "senders", "receivers", "edge_weight", "node_graph",
                "node_pos", "node_mask", "edge_mask", "has_self_loop",
                "row_ptr", "senders_t", "receivers_t", "edge_weight_t",
                "row_ptr_t", "in_degree")


def mismatches(got: GraphBatch, want: GraphBatch) -> list:
    """The arrays (and static fields) in which two batches differ: dtype,
    shape or any bit."""
    bad = [f for f in ("num_graphs", "max_nodes", "edges_sorted")
           if getattr(got, f) != getattr(want, f)]
    for f in BATCH_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None):
            bad.append(f)
        elif a is not None and not (a.dtype == b.dtype and a.shape == b.shape
                                    and torch.equal(_bits(a), _bits(b))):
            bad.append(f)
    return bad


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU, floats as the integers of their bits (so -0.0 and
    0.0 differ)."""
    t = t.detach().cpu()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()])
    return t
