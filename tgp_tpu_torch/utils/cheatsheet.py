"""Pooler capability cheatsheet (port of ``tgp_tpu/utils/cheatsheet.py``):
each registered pooler's capability flags, as rows or a markdown table.
The flags are the JAX package's; the paper references are parsed from
the port's own docstrings, so they need not match JAX's."""

from __future__ import annotations

import re
from typing import Dict, List

__all__ = ["pooler_capabilities", "cheatsheet_rows", "render_cheatsheet"]

_PAPER_RE = re.compile(r"https?://\S+|\(([^)]*\d{4}[^)]*)\)")


def pooler_capabilities(cls) -> Dict[str, bool]:
    """The five capability flags of a pooler class."""
    return {
        "sparse": not getattr(cls, "IS_DENSE", False),
        "dense": bool(getattr(cls, "IS_DENSE", False)),
        "trainable": bool(getattr(cls, "IS_TRAINABLE", False)),
        "aux_loss": bool(getattr(cls, "HAS_LOSS", False)),
        "precoarsenable": bool(getattr(cls, "IS_PRECOARSENABLE", False)),
    }


def _paper_refs(cls) -> List[str]:
    doc = cls.__doc__ or ""
    return [m.group(0) for m in _PAPER_RE.finditer(doc)][:2]


def cheatsheet_rows() -> List[dict]:
    """One row per alias of the port's ``pooler_map``, sorted by alias."""
    from tgp_tpu_torch.poolers import pooler_map

    rows = []
    for alias, cls in sorted(pooler_map().items()):
        caps = pooler_capabilities(cls)
        rows.append({"alias": alias, "class": cls.__name__, **caps,
                     "refs": _paper_refs(cls)})
    return rows


def render_cheatsheet() -> str:
    """The capability table in markdown."""
    rows = cheatsheet_rows()
    head = ("| alias | class | sparse | dense | trainable | aux loss | "
            "precoarsenable |\n|---|---|---|---|---|---|---|")
    body = "\n".join(
        "| {alias} | {class} | {s} | {d} | {t} | {l} | {p} |".format(
            alias=r["alias"], **{"class": r["class"]},
            s="✓" if r["sparse"] else "",
            d="✓" if r["dense"] else "",
            t="✓" if r["trainable"] else "",
            l="✓" if r["aux_loss"] else "",
            p="✓" if r["precoarsenable"] else "")
        for r in rows)
    return head + "\n" + body
