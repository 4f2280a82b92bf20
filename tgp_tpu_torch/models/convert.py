"""Carry flax weights of ``tgp_tpu``'s ``PoolingClassifier`` over to the
port's module, so both packages compute the same function."""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]

#: flax path → port name; ``{i}`` is the layer index
_RULES = (
    (r"(pre|post)_conv_(\d+)/Dense_0/kernel", r"\1_convs.\2.lin.weight", True),
    (r"(pre|post)_conv_(\d+)/bias", r"\1_convs.\2.bias", False),
    (r"pooler/selector/weight", r"pooler.selector.weight", False),
    (r"Dense_([01])/kernel", r"dense_\1.weight", True),
    (r"Dense_([01])/bias", r"dense_\1.bias", False),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``PoolingClassifier`` parameter tree (``{"params":
    ...}`` or its inner dict; leaves as numpy or JAX arrays) onto a
    ``state_dict`` for :class:`~tgp_tpu_torch.models.classifiers.
    PoolingClassifier`.  Dense kernels (``[in, out]``) are transposed for
    ``nn.Linear``.  Raises on a leaf it cannot place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        for pat, repl, transpose in _RULES:
            if re.fullmatch(pat, path):
                out[re.sub(pat, repl, path)] = torch.from_numpy(
                    np.ascontiguousarray(arr.T) if transpose else arr)
                break
        else:
            raise KeyError(f"no port parameter for flax leaf {path!r}")
    return out
