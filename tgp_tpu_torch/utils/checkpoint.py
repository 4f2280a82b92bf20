"""Checkpoints and persisted precoarsening (port of
``tgp_tpu/utils/checkpoint.py``).

Parameters are saved as ``torch.save`` of a module's ``state_dict``,
published atomically (written under a temporary name, then renamed into
place); the JAX package saves a flax tree with Orbax, so a checkpoint of
one package is not read by the other.  :class:`PrecoarsenCache` is a
numpy copy of JAX's npz artifact cache for precoarsened graphs, keyed by
the coarsening config and a hash of the graph.  Its level dicts are the
port's own layout, which differs from JAX's for NMF and EigenPool levels,
so an entry written by one package is not promised to be read by the
other.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from tgp_tpu_torch._device import DeviceLike, resolve_device

__all__ = ["save_params", "restore_params", "PrecoarsenCache"]

#: the file in a checkpoint directory
PARAMS_FILE = "params.pt"


def _file(path) -> Path:
    """The checkpoint file in the directory ``path``."""
    return Path(path).absolute() / PARAMS_FILE


def save_params(path, params: Union[nn.Module, Mapping[str, torch.Tensor]]
                ) -> Path:
    """Save a module's ``state_dict`` (or a state dict) into the directory
    ``path`` (made if missing) and return the file.  The tensors are
    written under a temporary name and renamed into place, so a reader
    never sees a half-written checkpoint; an existing one is replaced."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    state = {k: v.detach().cpu() for k, v in state.items()}
    target = _file(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.parent / f".{target.name}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, target)
    return target


def restore_params(path, like: Optional[nn.Module] = None,
                   device: DeviceLike = "cuda"):
    """Load the checkpoint in the directory ``path``.  With ``like`` (a
    module), load it into the module, on the module's device, and return
    the module; else return the state dict on ``device``."""
    target = _file(path)
    if like is not None:
        dev = next(iter(like.state_dict().values()), torch.empty(0)).device
        like.load_state_dict(torch.load(target, map_location=dev,
                                        weights_only=True))
        return like
    dev = resolve_device(device)
    return torch.load(target, map_location=dev, weights_only=True)


def _config_key(config: Any) -> str:
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class PrecoarsenCache:
    """Disk cache for per-graph precoarsening artifacts, keyed by the
    coarsening config and the graph (a corrupt entry is a miss)."""

    def __init__(self, root: str = "data/precoarsen_cache"):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, config, graph_hash: str) -> Path:
        return self.root / f"{_config_key(config)}_{graph_hash}.npz"

    @staticmethod
    def graph_hash(x: np.ndarray, edge_index: np.ndarray,
                   edge_weight: Optional[np.ndarray] = None) -> str:
        h = hashlib.sha256()
        # shape and dtype headers tell raw byte streams apart: without them
        # a [4,2] and a [2,4] feature matrix (or an x/edge_index boundary
        # shift) hash alike and serve the wrong cached coarsening
        for arr in (x, edge_index):
            a = np.ascontiguousarray(arr)
            h.update(repr((a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
        # the weights are part of the identity: Graclus's matching and
        # Kron's damping depend on them
        if edge_weight is not None:
            a = np.ascontiguousarray(edge_weight)
            h.update(repr((a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
        return h.hexdigest()[:16]

    def get(self, config, graph_hash: str) -> Optional[List[dict]]:
        path = self._path(config, graph_hash)
        if not path.exists():
            return None
        try:
            data = np.load(path, allow_pickle=True)
            return list(data["levels"])
        except Exception:
            # a truncated or corrupt entry is a miss, and is removed
            path.unlink(missing_ok=True)
            return None

    def put(self, config, graph_hash: str, levels: Sequence[dict]) -> None:
        path = self._path(config, graph_hash)
        # atomic publish: never a half-written npz at the final name (the
        # temporary name keeps the .npz suffix, which np.savez appends
        # otherwise)
        tmp = path.parent / f"{path.stem}.tmp{os.getpid()}.npz"
        np.savez_compressed(tmp, levels=np.asarray(levels, dtype=object))
        os.replace(tmp, path)

    def precoarsen_with_cache(self, transform, graphs: Sequence) -> List:
        """Apply a :class:`~tgp_tpu_torch.precoarsen.PreCoarsening`
        transform with caching (its ``poolers``/``levels``/``kwargs`` make
        the config key); a hit returns the same tuple as the cold
        ``transform(g)``."""
        from tgp_tpu_torch.data.transforms import split_graph_tuple

        config = {
            "poolers": transform.poolers,
            "levels": transform.levels,
            "kwargs": transform.kwargs,
        }
        out = []
        for g in graphs:
            x, ei, ew, y = split_graph_tuple(g)
            gh = self.graph_hash(x, ei, ew)
            cached = self.get(config, gh)
            if cached is not None:
                # the cold path drops an explicit-None weight slot too
                base = ((x, ei) + ((ew,) if ew is not None else ())
                        + ((y,) if y is not None else ()))
                out.append(base + (cached,))
                continue
            res = transform(g)
            self.put(config, gh, res[-1])
            out.append(res)
        return out
