"""Host-side data pipeline: transforms and static-budget loaders."""
from tgp_tpu_torch.data.loaders import (BucketedGraphLoader, GraphLoader,
                                        compute_budgets, worst_case_cycled)
from tgp_tpu_torch.data.pooled_loader import (LevelBatch, PooledGraphLoader,
                                              collate_level, separate_level)
from tgp_tpu_torch.data.transforms import (NormalizeAdj, SortNodes,
                                           split_graph_tuple)

__all__ = ["GraphLoader", "BucketedGraphLoader", "compute_budgets",
           "worst_case_cycled", "NormalizeAdj", "SortNodes",
           "split_graph_tuple", "LevelBatch", "PooledGraphLoader",
           "collate_level", "separate_level"]
