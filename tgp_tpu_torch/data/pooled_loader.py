"""Collation of precoarsened graphs into device batches (port of
``tgp_tpu/data/pooled_loader.py``).

Per level, the sparse assignments of the batch's graphs are offset
block-diagonally into one packed supernode space; dense (NMF) and eigen
(EigenPool) assignments take the port's unbatched layout — ``assignment``
rows over the previous level's packed node space, with each node's graph
position (``node_pos``) and the previous level's largest graph
(``max_nodes``), which the per-graph products of the dense reduce read;
an eigen level also carries ``num_modes``.  Budgets are fixed over the
dataset (the worst-case batch, as :class:`~tgp_tpu_torch.data.loaders.
GraphLoader` budgets its own), so every batch has the same shapes.  Each
level is built in numpy and moved to the device in one copy per dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tgp_tpu_torch._device import DeviceLike, resolve_device
from tgp_tpu_torch.data.loaders import GraphLoader, worst_case_cycled
from tgp_tpu_torch.graph import GraphBatch, ceil_to
from tgp_tpu_torch.select.base import SelectOutput

__all__ = ["collate_level", "separate_level", "PooledGraphLoader",
           "LevelBatch"]

Tensor = torch.Tensor


@dataclass(frozen=True)
class LevelBatch:
    """One pooling level: a :class:`SelectOutput` mapping the previous
    level's packed node space onto this level's supernodes, and the pooled
    connectivity as a :class:`GraphBatch` whose features are zeros (the
    model places its reduce output there)."""

    so: SelectOutput
    graph: GraphBatch

    def place_features(self, x_pool: Tensor) -> Tensor:
        """Reduce output in this level's packed node space ``[pad, F]``:
        a sparse reduce's rows as they are, a dense ``[B, K, F]`` one
        flattened graph-major; padded, zero off the node mask."""
        if x_pool.dim() == 3:
            B, K, F = x_pool.shape
            x_pool = x_pool.reshape(B * K, F)
        pad = self.graph.num_nodes - x_pool.shape[0]
        if pad > 0:
            x_pool = torch.cat([x_pool, x_pool.new_zeros(pad,
                                                         x_pool.shape[1])])
        return torch.where(self.graph.node_mask[:, None], x_pool, 0.0)

    def to(self, device: DeviceLike) -> "LevelBatch":
        dev = torch.device(device)

        def move(obj):
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(dev)
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), Tensor)})

        return LevelBatch(so=move(self.so), graph=move(self.graph))


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """Move numpy arrays to ``device`` in one copy per dtype: each dtype's
    arrays are packed into one buffer on the host, copied, and split into
    views."""
    by_dtype: Dict[np.dtype, List[str]] = {}
    for name, a in arrays.items():
        by_dtype.setdefault(a.dtype, []).append(name)
    out = {}
    for names in by_dtype.values():
        flat = np.concatenate([arrays[n].reshape(-1) for n in names])
        buf = torch.from_numpy(flat).to(device)
        off = 0
        for n in names:
            a = arrays[n]
            out[n] = buf[off:off + a.size].view(a.shape)
            off += a.size
    return out


def collate_level(levels: Sequence[dict], prev_node_offsets: np.ndarray,
                  prev_pad_nodes: int, pad_clusters: int, pad_edges: int,
                  max_clusters_per_graph: int, feature_dim: int = 1, *,
                  prev_max_nodes: Optional[int] = None,
                  device: DeviceLike = "cuda") -> LevelBatch:
    """Collate one level across the batch onto ``device``.

    ``prev_node_offsets[g]``: where graph *g*'s rows start in the previous
    level's packed node space; ``prev_pad_nodes``: its padded size;
    ``prev_max_nodes``: its largest graph (default: this batch's), the
    bound on a dense level's node positions."""
    device = resolve_device(device)
    B = len(levels)
    kind = levels[0]["kind"]
    k_per = [int(lv["num_clusters"]) for lv in levels]
    c_off = np.concatenate([[0], np.cumsum(k_per)[:-1]]).astype(np.int64)
    C_tot = int(sum(k_per))
    if C_tot > pad_clusters:
        raise ValueError(f"{C_tot} clusters exceed the budget of "
                         f"{pad_clusters}")
    n_per = [int(np.asarray(lv["cluster_index"] if "cluster_index" in lv
                            else lv["s"]).shape[0]) for lv in levels]
    if prev_max_nodes is None:
        prev_max_nodes = max(max(n_per), 1)

    cluster_graph = np.zeros(pad_clusters, np.int32)
    cluster_pos = np.zeros(pad_clusters, np.int32)
    out_node_mask = np.zeros(pad_clusters, bool)
    for g, k in enumerate(k_per):
        cluster_graph[c_off[g]: c_off[g] + k] = g
        cluster_pos[c_off[g]: c_off[g] + k] = np.arange(k)
        out_node_mask[c_off[g]: c_off[g] + k] = True
    cluster_graph[C_tot:] = B - 1

    # pooled edges, offset block-diagonally
    senders = np.zeros(pad_edges, np.int32)
    receivers = np.zeros(pad_edges, np.int32)
    edge_weight = np.zeros(pad_edges, np.float32)
    edge_mask = np.zeros(pad_edges, bool)
    e_run = 0
    for g, lv in enumerate(levels):
        ei, ew = np.asarray(lv["edge_index"]), np.asarray(lv["edge_weight"])
        e = ei.shape[1]
        if e_run + e > pad_edges:
            raise ValueError(f"the pooled edges exceed the budget of "
                             f"{pad_edges}")
        senders[e_run:e_run + e] = ei[0] + c_off[g]
        receivers[e_run:e_run + e] = ei[1] + c_off[g]
        edge_weight[e_run:e_run + e] = ew
        edge_mask[e_run:e_run + e] = True
        e_run += e
    has_self_loop = np.zeros(pad_clusters, bool)
    has_self_loop[senders[edge_mask & (senders == receivers)]] = True

    # the previous level's node space
    node_graph = np.full(prev_pad_nodes, B - 1, np.int32)
    node_pos = np.full(prev_pad_nodes, prev_max_nodes - 1, np.int32)
    node_mask_prev = np.zeros(prev_pad_nodes, bool)
    for g, n in enumerate(n_per):
        o = int(prev_node_offsets[g])
        node_graph[o:o + n] = g
        node_pos[o:o + n] = np.arange(n)
        node_mask_prev[o:o + n] = True

    arrays = dict(cluster_graph=cluster_graph, cluster_pos=cluster_pos,
                  out_node_mask=out_node_mask, senders=senders,
                  receivers=receivers, edge_weight=edge_weight,
                  edge_mask=edge_mask, has_self_loop=has_self_loop,
                  node_graph=node_graph, node_pos=node_pos,
                  node_mask_prev=node_mask_prev)
    if kind == "sparse":
        cluster_index = np.zeros(prev_pad_nodes, np.int32)
        weight = np.zeros(prev_pad_nodes, np.float32)
        sel_mask = np.zeros(prev_pad_nodes, bool)
        for g, lv in enumerate(levels):
            ci = np.asarray(lv["cluster_index"])
            o, n = int(prev_node_offsets[g]), ci.shape[0]
            valid = ci >= 0
            cluster_index[o:o + n] = np.where(valid, ci + c_off[g], 0)
            weight[o:o + n] = np.where(valid, np.asarray(lv["weight"]), 0.0)
            sel_mask[o:o + n] = valid
        arrays.update(cluster_index=cluster_index, weight=weight,
                      sel_mask=sel_mask)
    elif kind in ("dense", "eigen"):
        K = max(k_per)
        if len(set(k_per)) != 1:
            # the pooled graph packs supernodes at cumsum(k_per), but a
            # dense [B, K, F] reduce output flattens with a uniform stride
            raise ValueError(
                "dense/eigen precoarsen levels need a uniform per-graph "
                f"cluster count (fixed_k); got {sorted(set(k_per))}")
        num_modes = int(levels[0]["num_modes"]) if kind == "eigen" else 0
        key = "theta" if kind == "eigen" else "s"
        s = np.zeros((prev_pad_nodes, max(num_modes, 1) * K), np.float32)
        for g, lv in enumerate(levels):
            mat = np.asarray(lv[key], np.float32)
            o = int(prev_node_offsets[g])
            s[o:o + mat.shape[0], : mat.shape[1]] = mat
        arrays["s"] = s
    else:
        raise ValueError(f"unknown level kind {kind!r}")

    t = _to_device(arrays, device)
    pooled_graph = GraphBatch(
        x=torch.zeros(pad_clusters, feature_dim, device=device),
        senders=t["senders"], receivers=t["receivers"],
        edge_weight=t["edge_weight"], node_graph=t["cluster_graph"],
        node_pos=t["cluster_pos"], node_mask=t["out_node_mask"],
        edge_mask=t["edge_mask"], num_graphs=B,
        max_nodes=max_clusters_per_graph, has_self_loop=t["has_self_loop"])
    common = dict(node_graph=t["node_graph"], node_mask=t["node_mask_prev"],
                  node_pos=t["node_pos"], max_nodes=prev_max_nodes,
                  cluster_graph=t["cluster_graph"],
                  cluster_pos=t["cluster_pos"], num_graphs=B)
    if kind == "sparse":
        so = SelectOutput(
            cluster_index=t["cluster_index"], weight=t["weight"],
            node_sel_mask=t["sel_mask"], num_clusters=pad_clusters,
            max_clusters=max_clusters_per_graph,
            partial=any(lv.get("partial", False) for lv in levels),
            **common)
    else:
        so = SelectOutput(assignment=t["s"], num_clusters=K, max_clusters=K,
                          partial=False, num_modes=num_modes, **common)
    return LevelBatch(so=so, graph=pooled_graph)


def separate_level(lb: LevelBatch, prev_node_offsets: np.ndarray,
                   n_per_prev: Sequence[int]) -> List[dict]:
    """Inverse of :func:`collate_level`: per-graph level dicts (numpy)
    from a collated level.  ``prev_node_offsets``/``n_per_prev`` locate
    each graph's rows in the previous level's packed node space."""
    so, g = lb.so, lb.graph

    def host(t):
        return t.detach().cpu().numpy()

    B = g.num_graphs
    cluster_graph = host(g.node_graph)
    out_mask = host(g.node_mask)
    k_per = [int((out_mask & (cluster_graph == i)).sum()) for i in range(B)]
    c_off = np.concatenate([[0], np.cumsum(k_per)[:-1]]).astype(np.int64)

    senders, receivers = host(g.senders), host(g.receivers)
    ew, em = host(g.edge_weight), host(g.edge_mask)
    e_graph = cluster_graph[senders]
    if so.is_sparse:
        ci_all, sel_all = host(so.cluster_index), host(so.node_sel_mask)
        w_all = host(so.weight)
    else:
        s_all = host(so.assignment)

    out: List[dict] = []
    for i in range(B):
        o, n = int(prev_node_offsets[i]), int(n_per_prev[i])
        esel = em & (e_graph == i)
        level = {
            "num_clusters": k_per[i],
            "edge_index": np.stack([senders[esel] - c_off[i],
                                    receivers[esel] - c_off[i]]).astype(
                                        np.int64),
            "edge_weight": ew[esel].astype(np.float32),
        }
        if so.is_sparse:
            level["kind"] = "sparse"
            level["cluster_index"] = np.where(sel_all[o:o + n],
                                              ci_all[o:o + n] - c_off[i], -1)
            level["weight"] = w_all[o:o + n]
            level["partial"] = bool(so.partial)
        elif so.num_modes:
            level["kind"] = "eigen"
            level["num_modes"] = int(so.num_modes)
            level["theta"] = s_all[o:o + n]
        else:
            level["kind"] = "dense"
            level["s"] = s_all[o:o + n, : k_per[i]]
        out.append(level)
    return out


class PooledGraphLoader:
    """Minibatch iterator over precoarsened graphs (``(x, edge_index[,
    edge_weight], levels)`` tuples): yields ``(batch, level_batches[,
    labels])``, the base batch from a :class:`GraphLoader` (with which it
    shares its budgeting rule, :func:`worst_case_cycled`) and one
    :class:`LevelBatch` a level, all on ``device`` (default ``"cuda"``)."""

    def __init__(self, graphs: Sequence, labels=None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, *,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.with_weight = len(graphs[0]) == 4
        base = [g[:3] if self.with_weight else g[:2] for g in graphs]
        self.levels_per_graph = [g[-1] for g in graphs]
        self.num_levels = len(self.levels_per_graph[0])
        self.base_loader = GraphLoader(base, labels, batch_size=batch_size,
                                       shuffle=shuffle, seed=seed,
                                       device=self.device)
        self.batch_size = batch_size

        self.level_budgets = []
        for lvl in range(self.num_levels):
            ks = sorted((int(lv[lvl]["num_clusters"])
                         for lv in self.levels_per_graph), reverse=True)
            es = sorted((int(np.asarray(lv[lvl]["edge_index"]).shape[1])
                         for lv in self.levels_per_graph), reverse=True)
            pad_c = ceil_to(max(worst_case_cycled(ks, batch_size), 1), 8)
            pad_e = ceil_to(max(worst_case_cycled(es, batch_size), 1), 128)
            self.level_budgets.append((pad_c, pad_e, ks[0]))

    def __len__(self):
        return len(self.base_loader)

    def __iter__(self):
        for out in self._iter_with_indices():
            yield out[:-1]

    def _iter_with_indices(self):
        """Like ``__iter__``, also yielding the batch's source-graph
        indices (a short last batch cycles graphs)."""
        for batch, y, idx in self.base_loader._iter_with_indices():
            level_batches = []
            n_per = [self.base_loader.graphs[i][0].shape[0] for i in idx]
            prev_off = np.concatenate([[0], np.cumsum(n_per)[:-1]])
            prev_pad = self.base_loader.pad_nodes
            prev_max = self.base_loader.max_nodes
            F = batch.num_features
            for lvl in range(self.num_levels):
                pad_c, pad_e, kmax = self.level_budgets[lvl]
                levels = [self.levels_per_graph[i][lvl] for i in idx]
                level_batches.append(collate_level(
                    levels, prev_off, prev_pad, pad_c, pad_e, kmax,
                    feature_dim=F, prev_max_nodes=prev_max,
                    device=self.device))
                k_per = [int(lv["num_clusters"]) for lv in levels]
                prev_off = np.concatenate([[0], np.cumsum(k_per)[:-1]])
                prev_pad, prev_max = pad_c, kmax
            if y is not None:
                yield batch, level_batches, y, idx
            else:
                yield batch, level_batches, idx
