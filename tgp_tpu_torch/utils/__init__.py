"""Utilities."""
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["resolve_activation"]
