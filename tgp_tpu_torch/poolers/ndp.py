"""NDP pooling (port of ``tgp_tpu/poolers/ndp.py``; Bianchi et al., TNNLS
2020): the host-side NDP level (:func:`~tgp_tpu_torch.precoarsen.ndp.
ndp_level`), a sum reduce and a sparse lift.  For training,
:class:`~tgp_tpu_torch.precoarsen.PreCoarsening` runs it offline."""

from __future__ import annotations

from tgp_tpu_torch.poolers.host_base import HostPooling
from tgp_tpu_torch.precoarsen.ndp import ndp_level

__all__ = ["NDPPooling"]


class NDPPooling(HostPooling):
    """``"ndp"``."""

    def __init__(self, sparse_threshold: float = 1e-2, seed: int = 0):
        super().__init__()
        self.sparse_threshold = sparse_threshold
        self.seed = seed

    def level_fn(self):
        return ndp_level

    def level_kwargs(self):
        return {"sparse_threshold": self.sparse_threshold, "seed": self.seed}
