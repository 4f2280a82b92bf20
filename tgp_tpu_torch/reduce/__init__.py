"""Reduce operators."""
from tgp_tpu_torch.reduce.base import base_reduce, reduce_sparse
from tgp_tpu_torch.reduce.global_reduce import global_reduce

__all__ = ["base_reduce", "reduce_sparse", "global_reduce"]
