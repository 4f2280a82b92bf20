"""Carry flax weights of ``tgp_tpu``'s ``PoolingClassifier`` (with the
top-k, SAG, ASAP, PAN, edge-contraction, k-MIS or a dense soft-cluster
pooler, or one without parameters), ``DenseTopkClassifier`` and the
``PANNet`` of ``examples/classification_pan.py`` over to the port's
modules, so both packages compute the same function.  A flax gradient
tree has the same paths and maps the same way, so gradients compare leaf
by leaf."""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]

#: the PANNet's flax module names → the port's
_MODULES = {"PANConv_0": "pan_conv", "PANPooling_0": "pooler",
            "GCNConv_0": "conv"}

#: a layer inside a pooler (SAG's scorer, ASAP's layers) or a PANNet conv
_LAYER = r"((?:pooler|pan_conv|conv)(?:/\w+)?)"

#: flax path → port name (``/`` becomes ``.``); True where the leaf is a
#: dense kernel to transpose
_RULES = (
    (r"(pre|post)_conv_(\d+)/Dense_0/kernel", r"\1_convs.\2.lin.weight", True),
    (r"(pre|post)_conv_(\d+)/bias", r"\1_convs.\2.bias", False),
    (r"pooler/selector/weight", r"pooler.selector.weight", False),
    # the dense cluster family's MLPSelect
    (r"pooler/selector/SelectMLP_0/Dense_(\d+)/kernel",
     r"pooler.selector.mlp.layers.\1.weight", True),
    (r"pooler/selector/SelectMLP_0/Dense_(\d+)/bias",
     r"pooler.selector.mlp.layers.\1.bias", False),
    # the edge-contraction and k-MIS scorers
    (r"pooler/selector/lin/kernel", r"pooler.selector.lin.weight", True),
    (r"pooler/selector/lin/bias", r"pooler.selector.lin.bias", False),
    (r"p", r"p", False),  # DenseTopkClassifier's selector projection
    (r"Dense_([01])/kernel", r"dense_\1.weight", True),
    (r"Dense_([01])/bias", r"dense_\1.bias", False),
    # a conv's flax Dense_0 is the port's lin, its Dense_k lin_k (GCNConv,
    # GraphConv, LEConv, PANConv)
    (_LAYER + r"/Dense_0/kernel", r"\1.lin.weight", True),
    (_LAYER + r"/Dense_0/bias", r"\1.lin.bias", False),
    (_LAYER + r"/Dense_([12])/kernel", r"\1.lin_\2.weight", True),
    (_LAYER + r"/Dense_([12])/bias", r"\1.lin_\2.bias", False),
    (r"pooler/(lin|att)/kernel", r"pooler.\1.weight", True),  # ASAP
    (_LAYER + r"/(bias|hop_weight|p|beta)", r"\1.\2", False),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``PoolingClassifier``, ``DenseTopkClassifier`` or
    ``PANNet`` parameter (or gradient) tree (``{"params": ...}`` or its
    inner dict; leaves as numpy or JAX arrays) onto a ``state_dict`` of
    the port's module of the same name.  Dense kernels (``[in, out]``)
    are transposed for ``nn.Linear``.  Raises on a leaf it cannot
    place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        head, _, rest = path.partition("/")
        path = "/".join(filter(None, (_MODULES.get(head, head), rest)))
        for pat, repl, transpose in _RULES:
            if re.fullmatch(pat, path):
                name = re.sub(pat, repl, path).replace("/", ".")
                out[name] = torch.from_numpy(
                    np.ascontiguousarray(arr.T) if transpose else arr)
                break
        else:
            raise KeyError(f"no port parameter for flax leaf {path!r}")
    return out
