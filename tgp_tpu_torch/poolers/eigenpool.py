"""EigenPooling (port of ``tgp_tpu/poolers/eigenpool.py``; Ma et al., KDD
2019): the host-side EigenPool level (:func:`~tgp_tpu_torch.precoarsen.
eigenpool.eigenpool_level`), its mode-major reduce, which widens the
features to ``H·F`` (:func:`~tgp_tpu_torch.reduce.eigenpool.
eigenpool_reduce`), and its lift."""

from __future__ import annotations

from tgp_tpu_torch.lift.eigenpool import eigenpool_lift
from tgp_tpu_torch.poolers.host_base import HostPooling
from tgp_tpu_torch.precoarsen.eigenpool import eigenpool_level
from tgp_tpu_torch.reduce.eigenpool import eigenpool_reduce

__all__ = ["EigenPooling"]


class EigenPooling(HostPooling):
    """``"eigen"``.  ``normalized``: the subgraph Laplacian of the Θ modes
    is the normalized one (else the combinatorial)."""

    IS_DENSE = True

    def __init__(self, k: int = 8, num_modes: int = 3, seed: int = 0,
                 degree_norm: bool = True, normalized: bool = True):
        super().__init__()
        self.k = k
        self.num_modes = num_modes
        self.seed = seed
        self.degree_norm = degree_norm
        self.normalized = normalized

    def level_fn(self):
        return eigenpool_level

    def level_kwargs(self):
        return {"k": self.k, "num_modes": self.num_modes, "seed": self.seed,
                "normalized": self.normalized,
                "degree_norm": self.degree_norm}

    def reduce_level(self, x, so):
        return eigenpool_reduce(x, so)

    def lift_level(self, x_pool, so):
        return eigenpool_lift(x_pool, so)
