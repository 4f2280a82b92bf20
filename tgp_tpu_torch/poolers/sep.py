"""SEP pooling (port of ``tgp_tpu/poolers/sep.py``; Wu et al., ICML 2022):
structural-entropy coding-tree pooling on the host, one level from a tree
of ``max_height`` (:func:`~tgp_tpu_torch.precoarsen.sep.sep_levels`
derives every level of a multi-level rollout from one tree)."""

from __future__ import annotations

from tgp_tpu_torch.poolers.host_base import HostPooling
from tgp_tpu_torch.precoarsen.sep import sep_levels

__all__ = ["SEPPooling"]


class SEPPooling(HostPooling):
    """``"sep"``."""

    def __init__(self, max_height: int = 2):
        super().__init__()
        self.max_height = max_height

    def level_fn(self):
        def one_level(ei, n, ew, **kw):
            return sep_levels(ei, n, ew, levels=1,
                              max_height=self.max_height)[0]

        return one_level
