"""Gset MaxCut benchmark (port of ``tgp_tpu/datasets/gset.py``, a numpy
copy): the Stanford Gset parser and its download.  Without the file and
without a network the loader raises; :func:`parse_gset` parses the
standard format from a local file."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["parse_gset", "GsetDataset"]

_URL = "https://web.stanford.edu/~yyye/yyye/Gset/"


def parse_gset(path) -> tuple:
    """Parse the Gset format: first line ``n m``, then ``u v w`` 1-indexed
    edges.  Returns ``(x, edge_index, edge_weight)`` with degree features."""
    lines = Path(path).read_text().split("\n")
    n, m = map(int, lines[0].split()[:2])
    src, dst, w = [], [], []
    for line in lines[1 : m + 1]:
        parts = line.split()
        if len(parts) < 3:
            continue
        u, v, weight = int(parts[0]) - 1, int(parts[1]) - 1, float(parts[2])
        src += [u, v]
        dst += [v, u]
        w += [weight, weight]
    ei = np.array([src, dst], np.int64)
    ew = np.array(w, np.float32)
    deg = np.bincount(ei[0], minlength=n).astype(np.float32)
    x = deg[:, None] / max(deg.max(), 1.0)
    return x, ei, ew


@dataclass
class GsetDataset:
    name: str = "G14"
    root: str = "data/gset"

    def load(self):
        path = Path(self.root) / self.name
        if not path.exists():
            try:
                import urllib.request

                Path(self.root).mkdir(parents=True, exist_ok=True)
                urllib.request.urlretrieve(_URL + self.name, path)
            except Exception as exc:  # zero-egress environments
                raise RuntimeError(
                    f"Gset file {path} not found and download failed "
                    f"({exc}); place the file manually or use parse_gset "
                    f"on a local copy") from exc
        return parse_gset(path)
