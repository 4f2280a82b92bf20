"""Utilities: the activation resolver, checkpoints and the precoarsening
cache (:mod:`~tgp_tpu_torch.utils.checkpoint`), the pooler cheatsheet
(:mod:`~tgp_tpu_torch.utils.cheatsheet`) and the type aliases
(:mod:`~tgp_tpu_torch.utils.typing`)."""
from tgp_tpu_torch.utils.activations import resolve_activation

__all__ = ["resolve_activation"]
