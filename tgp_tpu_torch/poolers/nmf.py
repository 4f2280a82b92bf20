"""NMF pooling (port of ``tgp_tpu/poolers/nmf.py``; Bacciu & Di Sotto
2019): the host-side factorization level (:func:`~tgp_tpu_torch.
precoarsen.nmf.nmf_level`) collated with a fixed ``k``, the unbatched
dense reduce and lift."""

from __future__ import annotations

from tgp_tpu_torch.poolers.host_base import HostPooling
from tgp_tpu_torch.precoarsen.nmf import nmf_level

__all__ = ["NMFPooling"]


class NMFPooling(HostPooling):
    """``"nmf"``."""

    IS_DENSE = True

    def __init__(self, k: int = 8, seed: int = 0):
        super().__init__()
        self.k = k
        self.seed = seed

    def level_fn(self):
        return nmf_level

    def level_kwargs(self):
        return {"k": self.k, "seed": self.seed}
