"""Message-passing layers."""
from tgp_tpu_torch.mp.gcn import GCNConv, gcn_norm

__all__ = ["GCNConv", "gcn_norm"]
