"""Message-passing layers."""
from tgp_tpu_torch.mp.gcn import GCNConv, GraphConv, gcn_norm, gcn_norm_dense
from tgp_tpu_torch.mp.leconv import LEConv
from tgp_tpu_torch.mp.pan import PANConv

__all__ = ["GCNConv", "GraphConv", "LEConv", "PANConv", "gcn_norm",
           "gcn_norm_dense"]
