"""Pooler registry and string-alias factory (port of
``tgp_tpu/poolers/__init__.py``): the score-and-keep poolers ``"topk"``,
``"sag"``, ``"asap"`` and ``"pan"``, the clustering poolers ``"ec"``,
``"graclus"``, ``"kmis"`` and ``"nopool"``, LaPool (``"lap"``) and the
dense soft-cluster poolers ``"mincut"``, ``"diff"``, ``"dmon"``,
``"hosc"``, ``"jb"``, ``"acc"`` and ``"bnpool"``, MaxCut (``"maxcut"``),
and the host-side poolers ``"ndp"``, ``"nmf"``, ``"sep"`` and ``"eigen"``:
all 21 of JAX's aliases.

``get_pooler(alias, **kwargs)`` drops kwargs the pooler's constructor
does not take, translates the reference spellings ``lift=`` and
``nonlinearity=``, and accepts the ``"<alias>_u"`` suffix (unbatched-dense
mode, ``batched=False``, which the sparse poolers ignore).
:func:`register_pooler` adds an alias (the registry below is filled
through it), :func:`unregister_pooler` removes one.
"""

from __future__ import annotations

import inspect
from typing import Dict

from tgp_tpu_torch.poolers.asap import ASAPooling
from tgp_tpu_torch.poolers.asym_cheeger_cut import AsymCheegerCutPooling
from tgp_tpu_torch.poolers.bnpool import BNPool
from tgp_tpu_torch.poolers.dense_base import DenseClusterPooling
from tgp_tpu_torch.poolers.diffpool import DiffPool
from tgp_tpu_torch.poolers.dmon import DMoNPooling
from tgp_tpu_torch.poolers.edge_contraction import EdgeContractionPooling
from tgp_tpu_torch.poolers.eigenpool import EigenPooling
from tgp_tpu_torch.poolers.graclus import GraclusPooling
from tgp_tpu_torch.poolers.hosc import HOSCPooling
from tgp_tpu_torch.poolers.host_base import HostPooling
from tgp_tpu_torch.poolers.just_balance import JustBalancePooling
from tgp_tpu_torch.poolers.kmis import KMISPooling
from tgp_tpu_torch.poolers.lapool import LaPooling
from tgp_tpu_torch.poolers.maxcut import MaxCutPooling
from tgp_tpu_torch.poolers.mincut import MinCutPooling
from tgp_tpu_torch.poolers.ndp import NDPPooling
from tgp_tpu_torch.poolers.nmf import NMFPooling
from tgp_tpu_torch.poolers.nopool import NoPool
from tgp_tpu_torch.poolers.pan import PANPooling
from tgp_tpu_torch.poolers.sag import SAGPooling
from tgp_tpu_torch.poolers.sep import SEPPooling
from tgp_tpu_torch.poolers.topk import TopkPooling

__all__ = ["get_pooler", "pooler_map", "pooler_signature",
           "register_pooler", "unregister_pooler", "TopkPooling",
           "SAGPooling", "ASAPooling", "PANPooling",
           "EdgeContractionPooling", "GraclusPooling", "KMISPooling",
           "NoPool", "LaPooling", "DenseClusterPooling", "MinCutPooling",
           "DiffPool", "DMoNPooling", "HOSCPooling", "JustBalancePooling",
           "AsymCheegerCutPooling", "BNPool", "MaxCutPooling", "HostPooling",
           "NDPPooling", "NMFPooling", "SEPPooling", "EigenPooling"]

_REGISTRY: Dict[str, type] = {}


def register_pooler(alias: str, cls=None):
    """Register a pooler class under a string alias (a decorator, or a
    call with the class)."""
    def deco(c):
        _REGISTRY[alias] = c
        return c

    return deco if cls is None else deco(cls)


def unregister_pooler(alias: str) -> None:
    """Remove an alias from the registry (a no-op for an unknown one):
    :func:`pooler_map` returns a copy, so this is how a registration is
    undone."""
    _REGISTRY.pop(alias, None)


for _alias, _cls in (
        ("topk", TopkPooling), ("sag", SAGPooling), ("asap", ASAPooling),
        ("pan", PANPooling), ("ec", EdgeContractionPooling),
        ("graclus", GraclusPooling), ("kmis", KMISPooling),
        ("nopool", NoPool), ("lap", LaPooling), ("mincut", MinCutPooling),
        ("diff", DiffPool), ("dmon", DMoNPooling), ("hosc", HOSCPooling),
        ("jb", JustBalancePooling), ("acc", AsymCheegerCutPooling),
        ("bnpool", BNPool), ("maxcut", MaxCutPooling), ("ndp", NDPPooling),
        ("nmf", NMFPooling), ("sep", SEPPooling), ("eigen", EigenPooling)):
    register_pooler(_alias, _cls)


def pooler_map() -> Dict[str, type]:
    return dict(_REGISTRY)


def pooler_signature(cls) -> Dict[str, object]:
    """Constructor argument name → default (None where required); a
    constructor that passes ``**kwargs`` on adds its base class's."""
    out: Dict[str, object] = {}
    for klass in cls.__mro__:
        if "__init__" not in vars(klass):
            continue
        params = inspect.signature(klass.__init__).parameters
        for name, p in params.items():
            if name != "self" and p.kind not in (p.VAR_POSITIONAL,
                                                 p.VAR_KEYWORD):
                out.setdefault(name, None if p.default is p.empty
                               else p.default)
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return out


def get_pooler(alias: str, **kwargs):
    """Instantiate a pooler by alias with signature-filtered kwargs
    (``device=`` and ``generator=`` pass through to the pooler)."""
    name = alias
    if name.endswith("_u") and name not in _REGISTRY:
        name = name[: -len("_u")]
        kwargs.setdefault("batched", False)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown pooler {alias!r}; available: {sorted(_REGISTRY)}")
    cls = _REGISTRY[name]
    sig = pooler_signature(cls)
    for ref_name, our_name in (("lift", "lift_op"),
                               ("nonlinearity", "act"),
                               ("act", "nonlinearity")):
        if ref_name in kwargs and ref_name not in sig and our_name in sig:
            kwargs[our_name] = kwargs.pop(ref_name)
    return cls(**{k: v for k, v in kwargs.items() if k in sig})
