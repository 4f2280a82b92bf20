"""TU-format dataset parser (PROTEINS / NCI1 / MUTAG / DD …; port of
``tgp_tpu/datasets/tudataset.py``, a numpy copy that parses the same
graphs).  A dependency-free parser for the raw TU text format
(`https://chrsmrrs.github.io/datasets/`):

    <root>/<NAME>/<NAME>_A.txt                edge list, 1-based, "i, j"
    <root>/<NAME>/<NAME>_graph_indicator.txt  node -> graph id (1-based)
    <root>/<NAME>/<NAME>_graph_labels.txt     graph -> class label
    <root>/<NAME>/<NAME>_node_labels.txt      (opt) node -> int label
    <root>/<NAME>/<NAME>_node_attributes.txt  (opt) node -> float vector
    <root>/<NAME>/<NAME>_edge_attributes.txt  (opt) edge -> float vector

Output matches the rest of the package: ``(graphs, labels)`` where each
graph is ``(x [n,F] float32, edge_index [2,e] int64)`` and labels are
int32 class ids remapped to ``0..C-1``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["TUDataset", "parse_tu_dir"]


def _read_rows(path: Path) -> np.ndarray:
    """Parse a comma/whitespace-separated numeric text file to [rows, cols].

    Reads ``.txt.gz`` transparently (the committed PROTEINS_SYN/NCI1_SYN
    twin fixtures ship gzipped to keep the repo small)."""
    import gzip

    opener = gzip.open if path.name.endswith(".gz") else open
    rows = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.replace(",", " ").split()])
    return np.asarray(rows)


def _onehot_columns(lab: np.ndarray) -> list:
    """One-hot encode every column of an integer label matrix ``[n, C]``
    (each column shifted to start at 0), PyG read_tu_data style."""
    out = []
    for c in range(lab.shape[1]):
        col = lab[:, c] - lab[:, c].min()
        out.append(np.eye(int(col.max()) + 1, dtype=np.float32)[col])
    return out


def parse_tu_dir(root, name, use_node_attr=True, use_node_labels=True):
    """Parse one TU dataset directory into ``(graphs, labels, edge_attrs)``.

    ``edge_attrs`` is a per-graph list of ``[e, Fe]`` arrays (or None when
    the dataset ships no edge attributes).
    """
    d = Path(root) / name
    pre = d / name

    def p(suffix):
        plain = Path(f"{pre}_{suffix}.txt")
        gz = Path(f"{pre}_{suffix}.txt.gz")
        return plain if plain.exists() or not gz.exists() else gz

    if not p("A").exists():
        raise FileNotFoundError(
            f"TU dataset {name!r} not found under {d} (missing "
            f"{name}_A.txt). Download from chrsmrrs.github.io/datasets and "
            "unzip it there.")

    edges = _read_rows(p("A")).astype(np.int64) - 1            # [E, 2]
    graph_of = _read_rows(p("graph_indicator")).astype(np.int64)[:, 0] - 1
    y_raw = _read_rows(p("graph_labels"))[:, 0]
    n_graphs = int(graph_of.max()) + 1

    # features: concat(node attributes, one-hot node labels) — attribute
    # columns FIRST, then one-hot of EACH label column, matching PyG's
    # read_tu_data ordering (torch_geometric/io/tu.py); fallback degree feature when neither exists.
    feats = []
    if use_node_attr and p("node_attributes").exists():
        feats.append(_read_rows(p("node_attributes")).astype(np.float32))
    if use_node_labels and p("node_labels").exists():
        lab = _read_rows(p("node_labels")).astype(np.int64)
        feats.extend(_onehot_columns(lab))
    n_nodes = graph_of.shape[0]
    if feats:
        x_all = np.concatenate(feats, axis=1)
    else:  # degree feature, like common TU practice for unlabeled sets
        deg = np.zeros(n_nodes, np.float32)
        np.add.at(deg, edges[:, 0], 1.0)
        x_all = deg[:, None]

    # edge features: concat(edge attributes, one-hot edge labels) — same
    # PyG read_tu_data ordering as node features (attributes first, every
    # label column one-hot encoded; ADVICE r3).
    e_feats = []
    if p("edge_attributes").exists():
        e_feats.append(_read_rows(p("edge_attributes")).astype(np.float32))
    if p("edge_labels").exists():
        elab = _read_rows(p("edge_labels")).astype(np.int64)
        e_feats.extend(_onehot_columns(elab))
    e_attr_all = np.concatenate(e_feats, axis=1) if e_feats else None

    # classes remapped to 0..C-1 (TU labels may be {-1,1} or {1..C})
    classes = np.unique(y_raw)
    y = np.searchsorted(classes, y_raw).astype(np.int32)

    # split the global arrays per graph
    node_offset = np.zeros(n_graphs + 1, np.int64)
    np.add.at(node_offset, graph_of + 1, 1)
    node_offset = np.cumsum(node_offset)

    edge_graph = graph_of[edges[:, 0]]
    order = np.argsort(edge_graph, kind="stable")
    edges_sorted = edges[order]
    eg_sorted = edge_graph[order]
    e_attr_sorted = e_attr_all[order] if e_attr_all is not None else None
    edge_offset = np.searchsorted(eg_sorted, np.arange(n_graphs + 1))

    graphs, edge_attrs = [], []
    for g in range(n_graphs):
        lo, hi = node_offset[g], node_offset[g + 1]
        elo, ehi = edge_offset[g], edge_offset[g + 1]
        ei = (edges_sorted[elo:ehi] - lo).T.astype(np.int64)
        graphs.append((x_all[lo:hi], ei))
        edge_attrs.append(
            e_attr_sorted[elo:ehi] if e_attr_sorted is not None else None)
    return graphs, y, edge_attrs


@dataclass
class TUDataset:
    """TU benchmark dataset: ``load()`` gives ``(graphs, labels)``."""

    root: str = "data/tu"
    name: str = "PROTEINS"
    use_node_attr: bool = True
    use_node_labels: bool = True
    _cache: tuple = field(default=None, repr=False, compare=False)

    def load(self):
        if self._cache is None:
            g, y, ea = parse_tu_dir(self.root, self.name,
                                    self.use_node_attr, self.use_node_labels)
            object.__setattr__(self, "_cache", (g, y, ea))
        return self._cache[0], self._cache[1]

    @property
    def num_classes(self):
        self.load()
        return int(self._cache[1].max()) + 1

    @property
    def num_features(self):
        self.load()
        return self._cache[0][0][0].shape[1]

    def edge_attributes(self):
        self.load()
        return self._cache[2]
