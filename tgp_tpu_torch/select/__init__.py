"""Select operators."""
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.select.topk import (TopkSelect, topk_budget,
                                       topk_select_from_scores)

__all__ = ["SelectOutput", "TopkSelect", "topk_budget",
           "topk_select_from_scores"]
