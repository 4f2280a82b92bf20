"""Connect operators."""
from tgp_tpu_torch.connect.base import ConnectConfig, sparse_connect

__all__ = ["ConnectConfig", "sparse_connect"]
