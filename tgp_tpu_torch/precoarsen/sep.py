"""SEP, structural-entropy coding-tree pooling, on the host (port of
``tgp_tpu/precoarsen/sep.py``, the same algorithm and tie-breaks).

Reference: ``SEPSelect`` + ``PartitionTree``
(tgp/select/sep_select.py:45-1271; Wu et al., ICML 2022).  A coding tree of
bounded height is built by (1) greedy agglomerative merging of root children
minimizing two-level structural entropy, then (2) height compression by
repeatedly deleting the internal node whose removal increases entropy least.
Each tree layer yields one pooling level's hard partition, so **all levels
come from a single tree** (the reference's ``multi_level_select``,
sep_select.py:190-268).

This is an independent implementation of the published algorithm (greedy
structural-entropy minimization, Li & Pan 2016), not a port of the
reference's heap code; tie-breaking may differ.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional

import numpy as np

from tgp_tpu_torch import _native
from tgp_tpu_torch.precoarsen.common import coalesce_numpy, to_csr

__all__ = ["sep_coding_tree", "sep_levels"]


class _Node:
    __slots__ = ("id", "children", "parent", "vol", "cut", "leaves")

    def __init__(self, nid, vol=0.0, cut=0.0):
        self.id = nid
        self.children: List[int] = []
        self.parent: Optional[int] = None
        self.vol = vol
        self.cut = cut
        self.leaves: List[int] = []


def sep_coding_tree(edge_index, num_nodes, edge_weight=None,
                    max_height: int = 2, use_native: bool = True):
    """Build the coding tree; returns (nodes dict, root id).

    The merge phase runs in C++ (``_native.sep_merge_tree``) where a C++
    compiler is found (a failing build raises), else in the Python heap
    agglomeration (identical algorithm); ``use_native=False`` forces the
    Python one."""
    if use_native and _native.available():
        out = _sep_coding_tree_native(edge_index, num_nodes, edge_weight,
                                      max_height)
        _native.note_engine("native")
        return out
    _native.note_engine("numpy")
    A = to_csr(edge_index, num_nodes, edge_weight)
    A = A.maximum(A.T).tocsr()
    deg = np.asarray(A.sum(1)).ravel()
    V = float(deg.sum())
    if V <= 0:
        V = 1.0

    nodes: Dict[int, _Node] = {}
    next_id = num_nodes
    # leaves
    for i in range(num_nodes):
        n = _Node(i, vol=float(deg[i]), cut=float(deg[i] - A[i, i]))
        n.leaves = [i]
        nodes[i] = n

    # current root children = all leaves; inter-cluster weights
    cross: Dict[int, Dict[int, float]] = {i: {} for i in range(num_nodes)}
    coo = A.tocoo()
    for u, v, w in zip(coo.row, coo.col, coo.data):
        if u < v:
            cross[u][v] = cross[u].get(v, 0.0) + w
            cross[v][u] = cross[v].get(u, 0.0) + w

    alive = set(range(num_nodes))

    def merge_delta(a, b, w_ab):
        na, nb = nodes[a], nodes[b]
        vol_m = na.vol + nb.vol
        if vol_m <= 0:
            return -math.inf
        g_m = na.cut + nb.cut - 2 * w_ab
        before = 0.0
        after = 0.0
        for n in (na, nb):
            if n.vol > 0:
                before += -(n.cut / V) * math.log2(max(n.vol / V, 1e-12))
                after += -(n.cut / V) * math.log2(max(n.vol / vol_m, 1e-12))
        after += -(g_m / V) * math.log2(max(vol_m / V, 1e-12))
        return before - after  # entropy decrease (maximize)

    heap = []
    for a in alive:
        for b, w in cross[a].items():
            if a < b:
                d = merge_delta(a, b, w)
                heapq.heappush(heap, (-d, a, b))

    # --- merge phase: FULL binary agglomeration (best pair first, even
    # when entropy-increasing) until each component is one subtree.  The
    # compression phase then chooses which internal layers survive — the
    # same build-then-compress structure as the reference's PartitionTree
    # (sep_select.py:1228-1271); stopping at the first non-improving merge
    # (the round-2 behavior) strands singleton clusters under the root and
    # costs ~25-35% structural entropy (caught by the PartitionTree oracle
    # in tests/test_ref_parity_sep.py).
    while heap:
        negd, a, b = heapq.heappop(heap)
        if a not in alive or b not in alive:
            continue
        w_ab = cross[a].get(b, 0.0)
        d = merge_delta(a, b, w_ab)
        if abs(-negd - d) > 1e-9:  # stale entry: refresh and re-rank
            heapq.heappush(heap, (-d, a, b))
            continue
        m = next_id
        next_id += 1
        na, nb = nodes[a], nodes[b]
        nm = _Node(m, vol=na.vol + nb.vol, cut=na.cut + nb.cut - 2 * w_ab)
        nm.children = [a, b]
        nm.leaves = na.leaves + nb.leaves
        na.parent = m
        nb.parent = m
        nodes[m] = nm
        alive.discard(a)
        alive.discard(b)
        # merge cross rows
        row: Dict[int, float] = {}
        for src in (a, b):
            for c, w in cross[src].items():
                if c in alive:
                    row[c] = row.get(c, 0.0) + w
        cross[m] = row
        for c, w in row.items():
            cross[c].pop(a, None)
            cross[c].pop(b, None)
            cross[c][m] = w
            d2 = merge_delta(m, c, w)
            aa, bb = (m, c) if m < c else (c, m)
            heapq.heappush(heap, (-d2, aa, bb))
        alive.add(m)

    # root over remaining
    root = next_id
    nroot = _Node(root, vol=V, cut=0.0)
    nroot.children = sorted(alive)
    for c in alive:
        nodes[c].parent = root
    nroot.leaves = list(range(num_nodes))
    nodes[root] = nroot

    _flatten_tree(nodes, root, V, max_height, coo.row, coo.col, coo.data)
    _refine_root_layer(nodes, root, V, coo.row, coo.col, coo.data)
    return nodes, root


def _term(g, vol, denom, V):
    if vol <= 0:
        return 0.0
    return -(g / V) * math.log2(max(vol / denom, 1e-12))


def _subtree_postorder(nodes, top) -> List[int]:
    order = []
    stack = [top]
    while stack:
        cur = stack.pop()
        order.append(cur)
        stack.extend(nodes[cur].children)
    return order  # reversed(order) is a valid post-order (children first)


def _leaf_aggregates(nodes, order) -> Dict[int, tuple]:
    """Per subtree: (Σ_leaves cut_v, Σ_leaves cut_v·log2(vol_v)) — the
    sufficient statistics for a cluster's inner leaf-term sum."""
    agg: Dict[int, tuple] = {}
    for nid in reversed(order):
        n = nodes[nid]
        if not n.children:
            t = n.cut * math.log2(max(n.vol, 1e-12)) if n.vol > 0 else 0.0
            agg[nid] = (n.cut, t)
        else:
            agg[nid] = (sum(agg[c][0] for c in n.children),
                        sum(agg[c][1] for c in n.children))
    return agg


def _optimal_antichain(nodes, top, V):
    """Exact minimum two-level structural entropy over all antichains of the
    binary merge subtree rooted at ``top`` (tree DP: chosen subtrees are
    independent once the parent is the root, so
    best(t) = min(cost-as-cluster(t), Σ best(children))).  Returns
    (cost, chosen node ids).  Replaces the greedy one-at-a-time compression
    for ``max_height=2`` — greedy picks measurably worse antichains (caught
    by the PartitionTree oracle, tests/test_ref_parity_sep.py)."""
    order = _subtree_postorder(nodes, top)
    agg = _leaf_aggregates(nodes, order)
    best: Dict[int, float] = {}
    split: Dict[int, bool] = {}
    for nid in reversed(order):
        n = nodes[nid]
        c_sum, t_sum = agg[nid]
        inner = ((c_sum * math.log2(max(n.vol, 1e-12)) - t_sum) / V
                 if n.vol > 0 else 0.0)
        take = _term(n.cut, n.vol, V, V) + (inner if n.children else 0.0)
        if not n.children:
            best[nid], split[nid] = take, False
            continue
        sub = sum(best[c] for c in n.children)
        if take <= sub + 1e-12:
            best[nid], split[nid] = take, False
        else:
            best[nid], split[nid] = sub, True
    chosen = []
    stack = [top]
    while stack:
        cur = stack.pop()
        if split[cur]:
            stack.extend(nodes[cur].children)
        else:
            chosen.append(cur)
    return best[top], chosen


def _optimal_quotient_grouping(vols, cuts, Cs, Ts, cross, V):
    """Full greedy agglomeration of a quotient graph followed by the exact
    antichain DP — the same objective as ``_optimal_antichain`` with the
    original-node inner statistics (C, T) carried additively.  ``cross`` is
    a symmetric dict-of-dicts of inter-cluster weights.  Returns a list of
    groups ``(member quotient indices, vol, cut)`` covering all quotient
    nodes."""
    k = len(vols)
    vols, cuts = list(vols), list(cuts)
    Cs, Ts = list(Cs), list(Ts)
    children: List[tuple] = [() for _ in range(k)]
    cross = {i: dict(cross.get(i, {})) for i in range(k)}
    alive = set(range(k))

    def delta(a, b, w_ab):
        vol_m = vols[a] + vols[b]
        if vol_m <= 0:
            return -math.inf
        g_m = cuts[a] + cuts[b] - 2 * w_ab
        before = after = 0.0
        for x in (a, b):
            if vols[x] > 0:
                before += -(cuts[x] / V) * math.log2(max(vols[x] / V, 1e-12))
                after += -(cuts[x] / V) * math.log2(
                    max(vols[x] / vol_m, 1e-12))
        after += -(g_m / V) * math.log2(max(vol_m / V, 1e-12))
        return before - after

    heap = []
    for a in range(k):
        for b, w in cross[a].items():
            if a < b:
                heapq.heappush(heap, (-delta(a, b, w), a, b))
    while heap:
        negd, a, b = heapq.heappop(heap)
        if a not in alive or b not in alive:
            continue
        w_ab = cross[a].get(b, 0.0)
        d = delta(a, b, w_ab)
        if abs(-negd - d) > 1e-9:  # stale entry: refresh and re-rank
            heapq.heappush(heap, (-d, a, b))
            continue
        m = len(vols)
        vols.append(vols[a] + vols[b])
        cuts.append(cuts[a] + cuts[b] - 2 * w_ab)
        Cs.append(Cs[a] + Cs[b])
        Ts.append(Ts[a] + Ts[b])
        children.append((a, b))
        alive.discard(a)
        alive.discard(b)
        row: Dict[int, float] = {}
        for s in (a, b):
            for c2, w in cross[s].items():
                if c2 in alive:
                    row[c2] = row.get(c2, 0.0) + w
        cross[m] = row
        for c2, w in row.items():
            cross[c2].pop(a, None)
            cross[c2].pop(b, None)
            cross[c2][m] = w
            aa, bb = (m, c2) if m < c2 else (c2, m)
            heapq.heappush(heap, (-delta(m, c2, w), aa, bb))
        alive.add(m)

    # antichain DP (children always have smaller ids → ascending = postorder)
    best = [0.0] * len(vols)
    split = [False] * len(vols)
    for t in range(len(vols)):
        inner = ((Cs[t] * math.log2(max(vols[t], 1e-12)) - Ts[t]) / V
                 if vols[t] > 0 else 0.0)
        take = _term(cuts[t], vols[t], V, V) + inner
        if not children[t]:
            best[t] = take
            continue
        sub = sum(best[c] for c in children[t])
        if take <= sub + 1e-12:
            best[t] = take
        else:
            best[t], split[t] = sub, True

    groups = []
    for r in sorted(alive):
        stack = [r]
        while stack:
            t = stack.pop()
            if split[t]:
                stack.extend(children[t])
                continue
            mem, st = [], [t]
            while st:
                x = st.pop()
                if children[x]:
                    st.extend(children[x])
                else:
                    mem.append(x)
            groups.append((sorted(mem), vols[t], cuts[t]))
    return groups


def _flatten_tree(nodes, root, V, max_height, rows, cols, data) -> None:
    """Layered bottom-up layer selection replacing greedy one-at-a-time
    compression: the finest internal layer is the exact min-flat-entropy
    antichain of the binary merge tree; each coarser layer is the exact
    antichain DP over a fresh greedy agglomeration of the previous layer's
    quotient graph (nesting guaranteed by construction).  Greedy compression
    picked measurably worse layers — caught by the PartitionTree oracle
    (tests/test_ref_parity_sep.py)."""
    order = _subtree_postorder(nodes, root)
    agg = _leaf_aggregates(nodes, order)

    # --- finest layer: exact antichain per component
    fine = []
    for child in nodes[root].children:
        fine.extend(_optimal_antichain(nodes, child, V)[1])
    label: Dict[int, int] = {}
    layer = []
    for i, c in enumerate(sorted(fine)):
        n = nodes[c]
        Cc, Tc = agg[c]
        layer.append({"leaves": sorted(n.leaves), "vol": n.vol, "cut": n.cut,
                      "C": Cc, "T": Tc, "members": None})
        for leaf in n.leaves:
            label[leaf] = i
    layers = [layer]

    # --- coarser layers: quotient agglomeration + antichain DP
    for _ in range(max_height - 2):
        cross: Dict[int, Dict[int, float]] = {}
        for u, v, w in zip(rows, cols, data):
            u, v = int(u), int(v)
            if u >= v:
                continue
            a, b = label[u], label[v]
            if a == b:
                continue
            cross.setdefault(a, {})[b] = cross.get(a, {}).get(b, 0.0) + w
            cross.setdefault(b, {})[a] = cross.get(b, {}).get(a, 0.0) + w
        groups = _optimal_quotient_grouping(
            [c["vol"] for c in layer], [c["cut"] for c in layer],
            [c["C"] for c in layer], [c["T"] for c in layer], cross, V)
        new_layer = []
        glabel: Dict[int, int] = {}
        for gi, (mem, gvol, gcut) in enumerate(groups):
            new_layer.append({
                "leaves": sorted(l for m in mem for l in layer[m]["leaves"]),
                "vol": gvol, "cut": gcut,
                "C": sum(layer[m]["C"] for m in mem),
                "T": sum(layer[m]["T"] for m in mem),
                "members": mem})
            for m in mem:
                glabel[m] = gi
        label = {leaf: glabel[li] for leaf, li in label.items()}
        layers.append(new_layer)
        layer = new_layer

    # --- rebuild the node tree from the chosen layers (coarsest at depth 1)
    for nid in list(nodes):
        if nid != root and nodes[nid].children:
            del nodes[nid]
    next_id = max(nodes) + 1

    def build(li, idx, parent):
        nonlocal next_id
        info = layers[li][idx]
        if li == 0:
            kids = list(info["leaves"])
        else:
            kids = [build(li - 1, m, None) for m in info["members"]]
        if len(kids) == 1 and not nodes[kids[0]].children:
            # singleton chain down to a leaf: attach the leaf directly
            # (layer partitions treat an early leaf as its own cluster)
            nodes[kids[0]].parent = parent
            return kids[0]
        m = next_id
        next_id += 1
        nm = _Node(m, vol=info["vol"], cut=info["cut"])
        nm.children = kids
        nm.leaves = list(info["leaves"])
        nm.parent = parent
        for c in kids:
            nodes[c].parent = m
        nodes[m] = nm
        return m

    top = len(layers) - 1
    nodes[root].children = [build(top, i, root)
                            for i in range(len(layers[top]))]


def _refine_root_layer(nodes, root, V, rows, cols, data) -> None:
    """Local-improvement pass on the coarsest partition (the root's
    children): greedily ABSORB a sibling cluster into another (splice its
    children across — height never grows) while the two-level structural
    entropy strictly decreases.  The one-at-a-time compression can leave the
    top layer too fine; this recovers the reference-tree quality on the
    partitions actually used for pooling (bounded by the PartitionTree
    oracle, tests/test_ref_parity_sep.py)."""
    # leaf → root-child cluster label
    label = {}
    for cid in nodes[root].children:
        for leaf in nodes[cid].leaves:
            label[leaf] = cid
    # inter-cluster cut weights
    cross: Dict[int, Dict[int, float]] = {c: {} for c in nodes[root].children}
    for u, v, w in zip(rows, cols, data):
        if u >= v:
            continue
        ca, cb = label.get(int(u)), label.get(int(v))
        if ca is None or cb is None or ca == cb:
            continue
        cross[ca][cb] = cross[ca].get(cb, 0.0) + float(w)
        cross[cb][ca] = cross[cb].get(ca, 0.0) + float(w)

    def term(g, vol, denom):
        if vol <= 0:
            return 0.0
        return -(g / V) * math.log2(max(vol / denom, 1e-12))

    def absorb_delta(a, b, w_ab):
        """ΔH of combining root children a and b into one cluster: an
        internal node's children re-denominate vol_n → vol_m and its own
        term is replaced; a LEAF becomes a direct child of the combined
        cluster (it keeps its own term, re-denominated V → vol_m)."""
        na, nb = nodes[a], nodes[b]
        vol_m = na.vol + nb.vol
        g_m = na.cut + nb.cut - 2 * w_ab
        d = term(g_m, vol_m, V)
        for n in (na, nb):
            d -= term(n.cut, n.vol, V)
            if n.children:
                for c in n.children:
                    nc = nodes[c]
                    d += term(nc.cut, nc.vol, vol_m) \
                        - term(nc.cut, nc.vol, n.vol)
            else:
                d += term(n.cut, n.vol, vol_m)
        return d

    next_id = max(nodes) + 1
    while True:
        best, best_d = None, -1e-12
        for a, row in cross.items():
            for b, w in row.items():
                if a < b:
                    d = absorb_delta(a, b, w)
                    if d < best_d:
                        best, best_d = (a, b), d
        if best is None:
            break
        a, b = best
        # absorb into an INTERNAL node (swap so `a` is internal when
        # possible); two leaves get a fresh internal parent
        if not nodes[a].children and nodes[b].children:
            a, b = b, a
        na, nb = nodes[a], nodes[b]
        w_ab = cross[a].pop(b)
        cross[b].pop(a)
        if not na.children:  # both leaves → new internal cluster node
            m = next_id
            next_id += 1
            nm = _Node(m, vol=na.vol + nb.vol,
                       cut=na.cut + nb.cut - 2 * w_ab)
            nm.children = [a, b]
            nm.leaves = na.leaves + nb.leaves
            nm.parent = root
            na.parent = m
            nb.parent = m
            nodes[m] = nm
            kids = nodes[root].children
            kids[kids.index(a)] = m
            kids.remove(b)
            survivor = m
            cross[m] = {}
        else:
            na.vol += nb.vol
            na.cut = na.cut + nb.cut - 2 * w_ab
            if nb.children:  # splice b's children across; b disappears
                for c in nb.children:
                    nodes[c].parent = a
                na.children.extend(nb.children)
                na.leaves.extend(nb.leaves)
                del nodes[b]
            else:  # leaf b becomes a child of a
                nb.parent = a
                na.children.append(b)
                na.leaves.extend(nb.leaves)
            nodes[root].children.remove(b)
            survivor = a
        # merge cross rows of a and b into the survivor
        row_a = cross.pop(a)
        row_b = cross.pop(b)
        row = dict(row_a)
        for c, w in row_b.items():
            row[c] = row.get(c, 0.0) + w
        cross[survivor] = row
        for c, w in row.items():
            cross[c].pop(a, None)
            cross[c].pop(b, None)
            cross[c][survivor] = w

    _relocate_leaves(nodes, root, V, rows, cols, data)


def _relocate_leaves(nodes, root, V, rows, cols, data,
                     max_passes: int = 20) -> None:
    """Kernighan–Lin-style local search on the depth-1 partition of a FLAT
    tree (every root child is a leaf or has only leaf children — always true
    for ``max_height=2``): move one leaf to a neighboring cluster while the
    two-level structural entropy strictly decreases, then rebuild the layer.
    Skipped for deeper trees (moves would change subtree structure)."""
    kids = nodes[root].children
    for k in kids:
        if nodes[k].children and any(nodes[c].children
                                     for c in nodes[k].children):
            return  # not flat — deeper layers present

    leaves = sorted(nodes[root].leaves)
    label = {}
    for k in kids:
        for leaf in nodes[k].leaves:
            label[leaf] = k
    deg = {v: nodes[v].vol for v in leaves}
    # per-leaf neighbor lists (undirected weights; rows/cols cover both dirs)
    nbrs: Dict[int, List] = {v: [] for v in leaves}
    for u, v, w in zip(rows, cols, data):
        u, v = int(u), int(v)
        if u == v:
            continue
        nbrs[u].append((v, float(w)))

    vol = {k: nodes[k].vol for k in kids}
    g = {k: nodes[k].cut for k in kids}
    S = {k: sum(deg[v] * math.log2(max(deg[v], 1e-12))
                for v in nodes[k].leaves if deg[v] > 0) for k in kids}
    members = {k: set(nodes[k].leaves) for k in kids}

    def h_of(volx, gx, sx):
        if volx <= 0:
            return 0.0
        return (-(gx / V) * math.log2(max(volx / V, 1e-12))
                - (sx - volx * math.log2(max(volx, 1e-12))) / V)

    for _ in range(max_passes):
        moved = False
        for v in leaves:
            dv = deg[v]
            if dv <= 0:
                continue
            A = label[v]
            # self-loop weight never crosses a cluster boundary: keep it in
            # dv (volume) but OUT of the cut deltas, or every move of a
            # self-looped node drifts the entropy objective by A_vv
            w_to = {}
            sl = 0.0
            for u, w in nbrs[v]:
                if u == v:
                    sl += w
                    continue
                w_to[label[u]] = w_to.get(label[u], 0.0) + w
            w_vA = w_to.get(A, 0.0)
            dv_x = dv - sl  # boundary-crossing degree
            sv = dv * math.log2(max(dv, 1e-12))
            hA = h_of(vol[A], g[A], S[A])
            hA2 = h_of(vol[A] - dv, g[A] - dv_x + 2 * w_vA, S[A] - sv)
            best_b, best_d = None, -1e-12
            for B, w_vB in w_to.items():
                if B == A:
                    continue
                hB = h_of(vol[B], g[B], S[B])
                hB2 = h_of(vol[B] + dv, g[B] + dv_x - 2 * w_vB, S[B] + sv)
                d = (hA2 + hB2) - (hA + hB)
                if d < best_d:
                    best_b, best_d = B, d
            if best_b is not None:
                B, w_vB = best_b, w_to[best_b]
                vol[A] -= dv
                g[A] += -dv_x + 2 * w_vA
                S[A] -= sv
                vol[B] += dv
                g[B] += dv_x - 2 * w_vB
                S[B] += sv
                members[A].discard(v)
                members[B].add(v)
                label[v] = B
                moved = True
        if not moved:
            break

    # rebuild the depth-1 layer from the final membership
    next_id = max(nodes) + 1
    for k in list(kids):
        if nodes[k].children:
            del nodes[k]
    new_kids = []
    for k in sorted(members):
        mem = sorted(members[k])
        if not mem:
            continue
        if len(mem) == 1:
            leaf = mem[0]
            nodes[leaf].parent = root
            new_kids.append(leaf)
            continue
        m = next_id
        next_id += 1
        nm = _Node(m, vol=vol[k], cut=g[k])
        nm.children = mem
        nm.leaves = list(mem)
        nm.parent = root
        for leaf in mem:
            nodes[leaf].parent = m
        nodes[m] = nm
        new_kids.append(m)
    nodes[root].children = new_kids


def _sep_coding_tree_native(edge_index, num_nodes, edge_weight, max_height):
    # symmetrize like the Python path
    A = to_csr(edge_index, num_nodes, edge_weight)
    A = A.maximum(A.T).tocoo()
    ei = np.stack([A.row, A.col]).astype(np.int64)
    parent, vol, cut, n_total = _native.native_sep_merge(ei, num_nodes, A.data)

    nodes = {}
    V = max(float(vol[:num_nodes].sum()), 1.0)
    for i in range(n_total):
        nd = _Node(i, vol=float(vol[i]), cut=float(cut[i]))
        nodes[i] = nd
    for i in range(n_total):
        p = int(parent[i])
        if p >= 0:
            nodes[p].children.append(i)
            nodes[i].parent = p
    # leaves bottom-up
    for i in range(num_nodes):
        nodes[i].leaves = [i]
    for i in range(num_nodes, n_total):
        nodes[i].leaves = [l for c in nodes[i].children
                           for l in nodes[c].leaves]
    root = n_total
    nroot = _Node(root, vol=V, cut=0.0)
    nroot.children = sorted(i for i in range(n_total)
                            if nodes[i].parent is None)
    for c in nroot.children:
        nodes[c].parent = root
    nroot.leaves = list(range(num_nodes))
    nodes[root] = nroot

    # layer selection + top-layer refinement (shared with Python path)
    _flatten_tree(nodes, root, V, max_height, A.row, A.col, A.data)
    _refine_root_layer(nodes, root, V, A.row, A.col, A.data)
    return nodes, root


def sep_levels(edge_index, num_nodes, edge_weight=None, *,
               levels: int = 1, max_height: Optional[int] = None) -> list:
    """Derive ``levels`` hard partitions from one coding tree (coarse→fine
    rollout: level ℓ uses the tree layer at depth ``levels−ℓ`` … the finest
    usable layer first, like the reference's multi-level SEP)."""
    if max_height is None:
        max_height = levels + 1
    nodes, root = sep_coding_tree(edge_index, num_nodes, edge_weight,
                                  max_height=max_height)

    # depth-ℓ partition: cluster = ancestor at depth ℓ (or self if shallower)
    def layer_partition(depth_target):
        part = np.zeros(num_nodes, np.int64)
        cid = 0
        def walk(nid, depth):
            nonlocal cid
            n = nodes[nid]
            if depth == depth_target or not n.children:
                for leaf in n.leaves:
                    part[leaf] = cid
                cid += 1
                return
            for c in n.children:
                walk(c, depth + 1)
        walk(root, 0)
        return part, cid

    ei = np.asarray(edge_index)
    w = (np.ones(ei.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))

    out = []
    prev_cluster = None
    cur_ei, cur_w, cur_n = ei, w, num_nodes
    # deepest INTERNAL layer (parents of leaves) first, going coarser.
    # Leaves sit at root-relative depth ``max_height`` in a balanced tree, so
    # the usable layers are depths 1..max_height-1 — the reference's ref-depth
    # d (counted from leaves, sep_select.py:419-481) is our max_height-d.
    # (Round-2 used range(1, max_height+1), whose finest layer was the LEAF
    # layer itself — near-singleton clusters; caught by the PartitionTree
    # oracle in tests/test_ref_parity_sep.py.)
    # a tree of max_height has max_height-1 usable layers; requesting more
    # levels COLLAPSES to that many (documented + tested contract, matching
    # the one-tree multi-level rollout) rather than erroring
    depths = list(range(1, max_height))[::-1][:levels]
    for depth in depths:
        part, k = layer_partition(depth)
        if prev_cluster is None:
            level_assign = part
        else:
            # map previous level's clusters through this layer: every
            # previous cluster is contained in one node of the coarser layer
            level_assign = np.zeros(prev_k, np.int64)
            for node_idx in range(num_nodes):
                level_assign[prev_cluster[node_idx]] = part[node_idx]
        pooled = np.stack([level_assign[cur_ei[0]], level_assign[cur_ei[1]]])
        keep = pooled[0] != pooled[1]
        if keep.any():
            ei_pool, ew_pool = coalesce_numpy(pooled[:, keep], cur_w[keep],
                                              max(k, 1))
        else:
            ei_pool = np.zeros((2, 0), np.int64)
            ew_pool = np.zeros(0, np.float32)
        out.append({
            "kind": "sparse",
            "cluster_index": level_assign,
            "weight": np.ones(cur_n, np.float32),
            "num_clusters": k,
            "edge_index": ei_pool,
            "edge_weight": ew_pool.astype(np.float32),
            "partial": False,
        })
        prev_cluster = part
        prev_k = k
        cur_ei, cur_w, cur_n = ei_pool, ew_pool.astype(np.float32), k
    return out
