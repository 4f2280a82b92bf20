"""Precoarsening registry and the ``PreCoarsening`` transform (port of
``tgp_tpu/precoarsen/api.py``).

A per-level config list (alias, ``(alias, kwargs)``), consecutive identical
configs collapsed into one multi-level run, the level dicts attached to the
graph: a transformed graph is the tuple ``(x, edge_index[, edge_weight][,
y], levels)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

PRECOARSENERS: Dict[str, Tuple[Callable, bool]] = {}


def register_precoarsener(alias: str, fn: Optional[Callable] = None,
                          multi_level: bool = False):
    """Register a level function under ``alias`` (a call with ``fn``, or a
    decorator).  ``multi_level``: ``fn(..., levels=)`` returns every
    level itself (SEP's one coding tree)."""
    def deco(f):
        PRECOARSENERS[alias] = (f, multi_level)
        return f

    if fn is not None:
        return deco(fn)
    return deco


def _load_all():
    from tgp_tpu_torch.precoarsen.eigenpool import eigenpool_level
    from tgp_tpu_torch.precoarsen.graclus import graclus_level
    from tgp_tpu_torch.precoarsen.ndp import ndp_level
    from tgp_tpu_torch.precoarsen.nmf import nmf_level
    from tgp_tpu_torch.precoarsen.sep import sep_levels

    PRECOARSENERS.setdefault("ndp", (ndp_level, False))
    PRECOARSENERS.setdefault("graclus", (graclus_level, False))
    PRECOARSENERS.setdefault("nmf", (nmf_level, False))
    PRECOARSENERS.setdefault("eigen", (eigenpool_level, False))
    PRECOARSENERS.setdefault("sep", (sep_levels, True))


def precoarsen_graph(alias: str, edge_index, num_nodes, edge_weight=None,
                     levels: int = 1, **kw) -> List[dict]:
    """``levels`` level dicts of one method, each level's pooled graph
    feeding the next (a multi-level method makes them all at once)."""
    _load_all()
    if alias not in PRECOARSENERS:
        raise ValueError(
            f"unknown precoarsener {alias!r}; available: {sorted(PRECOARSENERS)}")
    fn, multi = PRECOARSENERS[alias]
    if multi:
        return fn(edge_index, num_nodes, edge_weight, levels=levels, **kw)
    out = []
    ei, ew, n = edge_index, edge_weight, num_nodes
    for _ in range(levels):
        lvl = fn(ei, n, ew, **kw)
        out.append(lvl)
        ei, ew, n = lvl["edge_index"], lvl["edge_weight"], lvl["num_clusters"]
    return out


@dataclass
class PreCoarsening:
    """Dataset transform: attach per-level coarsening artifacts.

    ``poolers`` is one config (repeated ``levels`` times) or a per-level
    list; a config is an alias (which takes ``kwargs``) or ``(alias,
    kwargs)``.  Consecutive identical configs run as one multi-level
    rollout."""

    poolers: Union[str, Tuple, Sequence] = "ndp"
    levels: int = 1
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def _normalized(self) -> List[Tuple[str, dict]]:
        cfgs = self.poolers
        if isinstance(cfgs, str):
            return [(cfgs, self.kwargs)] * self.levels
        if (isinstance(cfgs, tuple) and len(cfgs) == 2
                and isinstance(cfgs[1], dict)):
            return [cfgs] * self.levels
        out = []
        for c in cfgs:
            if isinstance(c, str):
                out.append((c, dict(self.kwargs)))
            elif (isinstance(c, tuple) and len(c) == 2
                    and isinstance(c[1], dict)):
                out.append(c)
            else:
                raise ValueError(
                    "per-level pooler config must be 'alias' or "
                    f"('alias', kwargs-dict); got {c!r}")
        return out

    def __call__(self, graph):
        from tgp_tpu_torch.data.transforms import split_graph_tuple

        x, ei, ew, y = split_graph_tuple(graph)
        n = x.shape[0]

        runs: List[Tuple[str, dict, int]] = []
        for alias, kw in self._normalized():
            if runs and runs[-1][0] == alias and runs[-1][1] == kw:
                runs[-1] = (alias, kw, runs[-1][2] + 1)
            else:
                runs.append((alias, kw, 1))

        levels: List[dict] = []
        cur_ei, cur_ew, cur_n = ei, ew, n
        for alias, kw, count in runs:
            lvls = precoarsen_graph(alias, cur_ei, cur_n, cur_ew,
                                    levels=count, **kw)
            levels.extend(lvls)
            last = lvls[-1]
            cur_ei, cur_ew = last["edge_index"], last["edge_weight"]
            cur_n = last["num_clusters"]

        return ((x, ei) + ((ew,) if ew is not None else ())
                + ((y,) if y is not None else ()) + (levels,))
