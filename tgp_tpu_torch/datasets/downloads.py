"""Download-backed datasets (port of ``tgp_tpu/datasets/downloads.py``, a
numpy copy): ``EXPWL1Dataset`` and ``GraphClassificationBench``.

Neither downloads: without its npz each raises with a pointer to
:class:`~tgp_tpu_torch.datasets.synthetic.SyntheticGraphClassification`
as the local stand-in.  With the raw file present they parse it:

- GraphClassificationBench: ``{easy,hard}[_small].npz`` with keys
  ``{tr,val,te}_{feat,adj,class}`` (dense adjacency, one-hot class).
- EXPWL1: the npz conversion of the upstream pickle (object arrays
  ``x``, ``edge_index``, ``y``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["EXPWL1Dataset", "GraphClassificationBench"]


def _load_npz_graphs(path):
    data = np.load(path, allow_pickle=True)
    graphs, labels = [], []
    for x, ei, y in zip(data["x"], data["edge_index"], data["y"]):
        graphs.append((np.asarray(x, np.float32), np.asarray(ei, np.int64)))
        labels.append(int(y))
    return graphs, np.asarray(labels, np.int32)


@dataclass
class EXPWL1Dataset:
    """1-WL expressiveness benchmark (download-backed)."""

    root: str = "data/expwl1"
    url: str = ("https://github.com/FilippoMB/"
                "The-expressive-power-of-pooling-in-GNNs/raw/main/data/"
                "EXPWL1/raw/EXPWL1.pkl")

    def load(self):
        path = Path(self.root) / "expwl1.npz"
        if path.exists():
            return _load_npz_graphs(path)
        raise RuntimeError(
            f"EXPWL1 requires a download ({self.url}); not available in "
            "zero-egress environments. Drop a preprocessed npz at "
            f"{path}, or use SyntheticGraphClassification for local runs.")


@dataclass
class GraphClassificationBench:
    """easy/hard × small/full benchmark (Bianchi et al. 2022).

    Parses the upstream raw npz directly: keys ``{tr,val,te}_feat`` (dense
    node features per graph), ``{tr,val,te}_adj`` (dense adjacency),
    ``{tr,val,te}_class`` (one-hot labels).  ``split`` selects
    train/val/test; ``easy`` and ``small`` select the archive name.
    """

    root: str = "data/gcb"
    split: str = "train"
    easy: bool = True
    small: bool = True

    @property
    def file_name(self) -> str:
        return ("easy" if self.easy else "hard") + \
            ("_small" if self.small else "")

    def load(self):
        split = self.split.lower()
        assert split in {"train", "val", "test"}
        key = "val" if split == "val" else split[:2]

        path = Path(self.root) / f"{self.file_name}.npz"
        if path.exists():
            npz = np.load(path, allow_pickle=True)
            graphs, labels = [], []
            for x, adj, y in zip(npz[f"{key}_feat"], npz[f"{key}_adj"],
                                 npz[f"{key}_class"]):
                adj = np.asarray(adj)
                if adj.ndim != 2:  # scipy-sparse stored as object
                    adj = adj.item().toarray()
                ei = np.stack(np.nonzero(adj)).astype(np.int64)
                graphs.append((np.asarray(x, np.float32), ei))
                labels.append(int(np.nonzero(np.asarray(y))[0][0]))
            return graphs, np.asarray(labels, np.int32)
        raise RuntimeError(
            f"GraphClassificationBench ({self.file_name}) requires a "
            f"download; not available in zero-egress environments. Drop the "
            f"npz at {path}, or use SyntheticGraphClassification for local "
            "runs.")
