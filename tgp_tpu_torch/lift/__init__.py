"""Lift operators."""
from tgp_tpu_torch.lift.base import base_lift, lift_dense_unbatched, lift_sparse

__all__ = ["base_lift", "lift_sparse", "lift_dense_unbatched"]
