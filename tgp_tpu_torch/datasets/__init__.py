"""Datasets (port of ``tgp_tpu/datasets``: numpy copies of every generator
and parser, with the JAX package's 13 public names).

The local generators (CSBM, multipartite, the synthetic benchmark, the
PyGSP-style graphs) work everywhere; the download-backed datasets
(EXPWL1, GraphClassificationBench, Gset) parse their raw files when they
are present and raise a clear error otherwise.
"""

from tgp_tpu_torch.datasets.csbm import CSBMDataset
from tgp_tpu_torch.datasets.downloads import (EXPWL1Dataset,
                                              GraphClassificationBench)
from tgp_tpu_torch.datasets.gset import GsetDataset, parse_gset
from tgp_tpu_torch.datasets.multipartite import MultipartiteGraphDataset
from tgp_tpu_torch.datasets.pygsp import (PYGSP_GRAPHS, PyGSPDataset,
                                          pygsp_graph)
from tgp_tpu_torch.datasets.synthetic import (SyntheticGraphClassification,
                                              csbm_graph)
from tgp_tpu_torch.datasets.tudataset import TUDataset, parse_tu_dir

__all__ = [
    "CSBMDataset",
    "GsetDataset",
    "parse_gset",
    "MultipartiteGraphDataset",
    "SyntheticGraphClassification",
    "csbm_graph",
    "EXPWL1Dataset",
    "GraphClassificationBench",
    "PyGSPDataset",
    "pygsp_graph",
    "PYGSP_GRAPHS",
    "TUDataset",
    "parse_tu_dir",
]
