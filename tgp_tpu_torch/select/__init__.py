"""Select operators."""
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import (TopkSelect, dense_topk_indices,
                                       dense_topk_select_output, topk_budget,
                                       topk_select_from_scores)

__all__ = ["SelectOutput", "TopkSelect", "topk_budget",
           "topk_select_from_scores", "dense_topk_indices",
           "dense_topk_select_output"]
