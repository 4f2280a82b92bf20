"""Message-passing layers."""
from tgp_tpu_torch.mp.gcn import GCNConv, gcn_norm, gcn_norm_dense

__all__ = ["GCNConv", "gcn_norm", "gcn_norm_dense"]
