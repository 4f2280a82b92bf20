"""Pooler registry and string-alias factory (port of
``tgp_tpu/poolers/__init__.py``): the score-and-keep poolers ``"topk"``,
``"sag"``, ``"asap"`` and ``"pan"``, the clustering poolers ``"ec"``,
``"graclus"``, ``"kmis"`` and ``"nopool"``, and LaPool (``"lap"``) are
ported so far.

``get_pooler(alias, **kwargs)`` drops kwargs the pooler's constructor
does not take, translates the reference spellings ``lift=`` and
``nonlinearity=``, and accepts the ``"<alias>_u"`` suffix (unbatched-dense
mode, ``batched=False``, which the sparse top-k pooler ignores).
"""

from __future__ import annotations

import inspect
from typing import Dict, Type

from tgp_tpu_torch.poolers.asap import ASAPooling
from tgp_tpu_torch.poolers.edge_contraction import EdgeContractionPooling
from tgp_tpu_torch.poolers.graclus import GraclusPooling
from tgp_tpu_torch.poolers.kmis import KMISPooling
from tgp_tpu_torch.poolers.lapool import LaPooling
from tgp_tpu_torch.poolers.nopool import NoPool
from tgp_tpu_torch.poolers.pan import PANPooling
from tgp_tpu_torch.poolers.sag import SAGPooling
from tgp_tpu_torch.poolers.topk import TopkPooling
from tgp_tpu_torch.src import SRCPooling

__all__ = ["get_pooler", "pooler_map", "pooler_signature", "TopkPooling",
           "SAGPooling", "ASAPooling", "PANPooling",
           "EdgeContractionPooling", "GraclusPooling", "KMISPooling",
           "NoPool", "LaPooling"]

_REGISTRY: Dict[str, Type[SRCPooling]] = {
    "topk": TopkPooling, "sag": SAGPooling, "asap": ASAPooling,
    "pan": PANPooling, "ec": EdgeContractionPooling,
    "graclus": GraclusPooling, "kmis": KMISPooling, "nopool": NoPool,
    "lap": LaPooling}


def pooler_map() -> Dict[str, Type[SRCPooling]]:
    return dict(_REGISTRY)


def pooler_signature(cls) -> Dict[str, object]:
    """Constructor argument name → default (None where required)."""
    return {
        name: (None if p.default is inspect.Parameter.empty else p.default)
        for name, p in inspect.signature(cls.__init__).parameters.items()
        if name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
    }


def get_pooler(alias: str, **kwargs) -> SRCPooling:
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
