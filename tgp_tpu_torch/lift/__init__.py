"""Lift operators."""
from tgp_tpu_torch.lift.base import (base_lift, lift_dense_batched,
                                     lift_dense_unbatched, lift_sparse)
from tgp_tpu_torch.lift.eigenpool import eigenpool_lift

__all__ = ["base_lift", "lift_dense_batched", "lift_dense_unbatched",
           "lift_sparse", "eigenpool_lift"]
