"""Carry flax weights of ``tgp_tpu``'s ``PoolingClassifier`` (with the
top-k, SAG, ASAP, PAN, edge-contraction, k-MIS, MaxCut, a dense
soft-cluster pooler or BNPool, or one without parameters), ``DenseTopkClassifier``, the
``PANNet`` of ``examples/classification_pan.py``, an ``AggrReduce``, the
``Net`` of ``examples/classification_aggr_reduce.py``, the
``PrecoarsenedNet`` of ``examples/pre_coarsening.py``, a
``ClusteringModel`` (GCN or GTV layers), a ``PoolLiftNodeClassifier`` and
the ``TopkPoolModel`` of ``parallel/sparse_pool.py`` (top-k or SAG; a bare
pooler's tree goes under ``"pooler"``) over to the port's modules, so both
packages compute the same function;
and the plain parameter dict of ``tgp_tpu.parallel.pooled_model``
(:func:`pooled_params_from_numpy`).
A flax gradient tree has the same paths and maps the same way, so
gradients compare leaf by leaf."""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "pooled_params_from_numpy"]

#: the PANNet's, the aggregation Net's, the PrecoarsenedNet's and the
#: clustering and autoencoder models' flax module names → the port's
#: (``GCNConv_<i>`` and ``GTVConv_<i>``, i ≥ 1, → ``conv_<i>``)
_MODULES = {"PANConv_0": "pan_conv", "PANPooling_0": "pooler",
            "GCNConv_0": "conv", "GTVConv_0": "conv",
            "AggrReduce_0": "aggr_reduce"}

#: a layer inside a pooler (SAG's scorer, ASAP's layers) or a conv
_LAYER = r"((?:pooler|pan_conv|conv|conv_\d+)(?:/\w+)?)"

#: an aggregation module of ``reduce/aggr.py`` in an ``AggrReduce`` (alone,
#: or the Net's), named by its class or, when the module was passed in, by
#: the field ``aggr``: the port's ``AggrReduce.aggr``
_AGGR = (r"((?:aggr_reduce/)?)(?:aggr|(?:AttentionalAggregation|Set2Set|"
         r"LSTMAggregation|GRUAggregation|DeepSetsAggregation|MLPAggregation|"
         r"SetTransformerAggregation|EquilibriumAggregation|LCMAggregation|"
         r"PatchTransformerAggregation|GraphMultisetTransformer)_0)")


def _qkv(a):  # DenseGeneral [F, H, D] → nn.Linear [H·D, F]
    return a.reshape(a.shape[0], -1).T


def _out(a):  # DenseGeneral [H, D, F] → nn.Linear [F, H·D]
    return a.reshape(-1, a.shape[-1]).T


def _flat(a):  # a [H, D] bias
    return a.reshape(-1)


#: flax path → port name (``/`` becomes ``.``) and the change of layout:
#: True where the leaf is a dense kernel to transpose, or a function
_RULES = (
    (r"(pre|post)_conv_(\d+)/Dense_0/kernel", r"\1_convs.\2.lin.weight", True),
    (r"(pre|post)_conv_(\d+)/bias", r"\1_convs.\2.bias", False),
    (r"pooler/selector/weight", r"pooler.selector.weight", False),
    # the dense cluster family's MLPSelect
    (r"pooler/selector/SelectMLP_0/Dense_(\d+)/kernel",
     r"pooler.selector.mlp.layers.\1.weight", True),
    (r"pooler/selector/SelectMLP_0/Dense_(\d+)/bias",
     r"pooler.selector.mlp.layers.\1.bias", False),
    # BNPool's connectivity matrix
    (r"pooler/K", r"pooler.K", False),
    # MaxCut's score net: Dense_i in creation order, mp_bias_i per round
    (r"pooler/selector/MaxCutScoreNet_0/Dense_(\d+)/kernel",
     r"pooler.selector.score_net.layers.\1.weight", True),
    (r"pooler/selector/MaxCutScoreNet_0/Dense_(\d+)/bias",
     r"pooler.selector.score_net.layers.\1.bias", False),
    (r"pooler/selector/MaxCutScoreNet_0/mp_bias_(\d+)",
     r"pooler.selector.score_net.mp_bias.\1", False),
    # the edge-contraction and k-MIS scorers
    (r"pooler/selector/lin/kernel", r"pooler.selector.lin.weight", True),
    (r"pooler/selector/lin/bias", r"pooler.selector.lin.bias", False),
    (r"p", r"p", False),  # DenseTopkClassifier's selector projection
    # parallel/sparse_pool.py's TopkPoolModel
    (r"(lin1|lin2|head)/kernel", r"\1.weight", True),
    (r"(lin1|lin2|head)/bias", r"\1.bias", False),
    (r"Dense_([01])/kernel", r"dense_\1.weight", True),
    (r"Dense_([01])/bias", r"dense_\1.bias", False),
    # a conv's flax Dense_0 is the port's lin, its Dense_k lin_k (GCNConv,
    # GraphConv, LEConv, PANConv)
    (_LAYER + r"/Dense_0/kernel", r"\1.lin.weight", True),
    (_LAYER + r"/Dense_0/bias", r"\1.lin.bias", False),
    (_LAYER + r"/Dense_([12])/kernel", r"\1.lin_\2.weight", True),
    (_LAYER + r"/Dense_([12])/bias", r"\1.lin_\2.bias", False),
    (r"pooler/(lin|att)/kernel", r"pooler.\1.weight", True),  # ASAP
    # GTVConv's weight [in, out] keeps the flax layout
    (_LAYER + r"/(bias|hop_weight|p|beta|weight)", r"\1.\2", False),
    # the aggregations: dense layers by flax's names (Dense_i → dense_i),
    # attention blocks (MultiHeadDotProductAttention_i → attn_i), layer
    # norms (LayerNorm_i → norm_i) and parameters of their own
    (_AGGR + r"/Dense_(\d+)/kernel", r"\1aggr.dense_\2.weight", True),
    (_AGGR + r"/Dense_(\d+)/bias", r"\1aggr.dense_\2.bias", False),
    (_AGGR + r"/(pot1|pot2|proj|comb1|comb2|patch_mlp|out)/kernel",
     r"\1aggr.\2.weight", True),
    (_AGGR + r"/(pot1|pot2|proj|comb1|comb2|patch_mlp|out)/bias",
     r"\1aggr.\2.bias", False),
    (_AGGR + r"/MultiHeadDotProductAttention_(\d+)/(query|key|value)/kernel",
     r"\1aggr.attn_\2.\3.weight", _qkv),
    (_AGGR + r"/MultiHeadDotProductAttention_(\d+)/(query|key|value)/bias",
     r"\1aggr.attn_\2.\3.bias", _flat),
    (_AGGR + r"/MultiHeadDotProductAttention_(\d+)/out/kernel",
     r"\1aggr.attn_\2.out.weight", _out),
    (_AGGR + r"/MultiHeadDotProductAttention_(\d+)/out/bias",
     r"\1aggr.attn_\2.out.bias", False),
    (_AGGR + r"/LayerNorm_(\d+)/scale", r"\1aggr.norm_\2.weight", False),
    (_AGGR + r"/LayerNorm_(\d+)/bias", r"\1aggr.norm_\2.bias", False),
    (_AGGR + r"/norm/scale", r"\1aggr.norm.weight", False),
    (_AGGR + r"/norm/bias", r"\1aggr.norm.bias", False),
    (_AGGR + r"/(seeds|seed_out|pos|log_lr)", r"\1aggr.\2", False),
)

#: a gate of flax's LSTM and GRU cells: (cell, input or hidden side, gate,
#: kernel or bias) → the torch cell's stacked tensor and the gate's slot
_GATE = _AGGR + (r"/(LSTMCell|OptimizedLSTMCell|GRUCell)_0/"
                 r"([ih])([ifgorzn])/(kernel|bias)")
#: each cell's torch module, its tensors' suffix, and its gate order
_CELLS = {"LSTMCell": ("cell", "", "ifgo"),
          "OptimizedLSTMCell": ("rnn", "_l0", "ifgo"),
          "GRUCell": ("rnn", "_l0", "rzn")}


def _place_gate(m: "re.Match", arr: np.ndarray, gates: dict) -> None:
    """File one gate leaf of an LSTM or GRU cell under its torch tensor
    (``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``) and slot."""
    prefix, cell, side, gate, kind = m.groups()
    module, suffix, order = _CELLS[cell]
    what = "weight" if kind == "kernel" else "bias"
    name = f"{prefix}aggr.{module}.{what}_{side}h{suffix}".replace("/", ".")
    gates.setdefault(name, [None] * len(order))[order.index(gate)] = (
        arr.T if kind == "kernel" else arr)


def _stack_gates(gates: dict) -> Dict[str, torch.Tensor]:
    """Each cell's gate leaves stacked in torch's gate order; a bias flax
    does not have (an LSTM's input bias, a GRU's r and z hidden biases)
    is zero."""
    out = {}
    for name, parts in gates.items():
        width = next(p for p in parts if p is not None).shape[0]
        out[name] = torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [np.zeros(width, np.float32) if p is None else p
             for p in parts])))
    for name in list(out):  # an LSTM's input bias: flax has none
        if ".weight_ih" in name:
            bias = name.replace(".weight_ih", ".bias_ih")
            if bias not in out:
                out[bias] = torch.zeros(out[name].shape[0])
    return out


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``PoolingClassifier``, ``DenseTopkClassifier``,
    ``PANNet``, ``AggrReduce``, aggregation ``Net``, ``PrecoarsenedNet``,
    ``ClusteringModel``, ``PoolLiftNodeClassifier`` or ``TopkPoolModel``
    parameter (or
    gradient) tree (``{"params": ...}`` or its inner dict; leaves as numpy
    or JAX arrays) onto a ``state_dict`` of the port's module of the same
    name.  Dense kernels (``[in, out]``) are transposed for ``nn.Linear``,
    attention kernels flattened over their heads, and an LSTM's or GRU's
    gate leaves stacked in torch's gate order.  Raises on a leaf it
    cannot place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out, gates = {}, {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        head, _, rest = path.partition("/")
        head = _MODULES.get(head, re.sub(r"^(?:GCN|GTV)Conv_(\d+)$",
                                         r"conv_\1", head))
        path = "/".join(filter(None, (head, rest)))
        m = re.fullmatch(_GATE, path)
        if m:
            _place_gate(m, arr, gates)
            continue
        for pat, repl, layout in _RULES:
            if re.fullmatch(pat, path):
                name = re.sub(pat, repl, path).replace("/", ".")
                arr = (arr.T if layout is True else
                       layout(arr) if callable(layout) else arr)
                out[name] = torch.from_numpy(arr.copy(order="C"))
                break
        else:
            raise KeyError(f"no port parameter for flax leaf {path!r}")
    out.update(_stack_gates(gates))
    return out


def pooled_params_from_numpy(params: Mapping[str, Any], *,
                             device="cpu") -> Dict[str, torch.Tensor]:
    """The sharded pooled model's parameters (``init_pooled_params``' dict:
    ``W1 b1 Wh bh p{l} W{l+2} b{l+2}``, numpy or JAX arrays; the same
    names and layouts in both packages) as float32 leaf tensors on
    ``device`` that require a gradient, in the same key order."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True) for k, v in params.items()}
