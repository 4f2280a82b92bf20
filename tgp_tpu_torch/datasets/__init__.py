"""Datasets (port of ``tgp_tpu/datasets``; the local synthetic generators
so far)."""
from tgp_tpu_torch.datasets.synthetic import (SyntheticGraphClassification,
                                              csbm_graph)

__all__ = ["SyntheticGraphClassification", "csbm_graph"]
