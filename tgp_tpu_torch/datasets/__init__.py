"""Datasets (port of ``tgp_tpu/datasets``; the local synthetic generator
so far)."""
from tgp_tpu_torch.datasets.synthetic import SyntheticGraphClassification

__all__ = ["SyntheticGraphClassification"]
