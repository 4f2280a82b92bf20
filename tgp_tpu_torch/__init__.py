"""tgp_tpu_torch — the PyTorch/CUDA port of ``tgp_tpu``.

Same module layout and public names as the JAX package.  Imports torch
and numpy only; the CUDA kernels (``csrc/``) are built with ``nvcc`` at
their first launch.  Entry points (``from_graphs``, ``Predictor``, model
and pooler construction) run on ``device="cuda"`` unless given
``device="cpu"``.
"""

from tgp_tpu_torch.graph import (DenseGraphBatch, GraphBatch, from_dense,
                                 from_graphs, to_dense)
from tgp_tpu_torch.models.classifiers import PoolingClassifier
from tgp_tpu_torch.models.inference import Predictor
from tgp_tpu_torch.poolers import get_pooler, pooler_map
from tgp_tpu_torch.select.base import SelectOutput
from tgp_tpu_torch.src import PoolingOutput, SRCPooling

__version__ = "0.1.0"

__all__ = ["GraphBatch", "DenseGraphBatch", "from_graphs", "to_dense",
           "from_dense", "PoolingClassifier", "Predictor", "get_pooler",
           "pooler_map", "SelectOutput", "PoolingOutput", "SRCPooling"]
