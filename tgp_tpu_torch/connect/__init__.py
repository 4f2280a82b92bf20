"""Connect operators."""
from tgp_tpu_torch.connect.base import (ConnectConfig, dense_connect,
                                        dense_connect_unbatched,
                                        sparse_connect)

__all__ = ["ConnectConfig", "dense_connect", "dense_connect_unbatched",
           "sparse_connect"]
