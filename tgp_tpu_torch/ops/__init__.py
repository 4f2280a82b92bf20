"""Graph ops: segment reductions, sparse connectivity, kernels (the JAX
package's ``tgp_tpu.ops`` names re-exported)."""

from tgp_tpu_torch.ops.segment import (
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_normalize,
    segment_softmax,
    segment_sum,
    segment_topk_rank,
)
from tgp_tpu_torch.ops.sparse import (
    add_remaining_self_loops,
    check_and_filter_edge_weights,
    coalesce,
    normalize_adj_sym,
    postprocess_adj_dense,
    postprocess_adj_sparse,
    rank3_diag,
    rank3_trace,
    remove_self_loops,
    sddmm,
    spmm,
    weighted_degree,
)

__all__ = [
    "segment_count",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_normalize",
    "segment_softmax",
    "segment_sum",
    "segment_topk_rank",
    "add_remaining_self_loops",
    "check_and_filter_edge_weights",
    "coalesce",
    "normalize_adj_sym",
    "postprocess_adj_dense",
    "postprocess_adj_sparse",
    "rank3_diag",
    "rank3_trace",
    "remove_self_loops",
    "sddmm",
    "spmm",
    "weighted_degree",
]
