"""Reduce operators."""
from tgp_tpu_torch.reduce.aggr import AggrReduce, aggr_aliases, get_aggr
from tgp_tpu_torch.reduce.base import (base_reduce, reduce_dense_batched,
                                       reduce_dense_unbatched, reduce_sparse)
from tgp_tpu_torch.reduce.eigenpool import eigenpool_reduce
from tgp_tpu_torch.reduce.global_reduce import global_reduce

__all__ = ["base_reduce", "reduce_sparse", "reduce_dense_batched",
           "reduce_dense_unbatched",
           "global_reduce", "AggrReduce", "aggr_aliases", "get_aggr",
           "eigenpool_reduce"]
