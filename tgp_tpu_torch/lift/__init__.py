"""Lift operators."""
from tgp_tpu_torch.lift.base import base_lift, lift_sparse

__all__ = ["base_lift", "lift_sparse"]
