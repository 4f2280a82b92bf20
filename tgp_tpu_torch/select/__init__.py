"""Select operators."""
from tgp_tpu_torch.select.base import (SelectOutput, cluster_to_select_output,
                                       compact_select_output)
from tgp_tpu_torch.select.edge_contraction import (EdgeContractionSelect,
                                                   matching,
                                                   maximal_matching,
                                                   maximal_matching_dense)
from tgp_tpu_torch.select.graclus import graclus_select
from tgp_tpu_torch.select.kmis import (KMISSelect, maximal_independent_set,
                                       maximal_independent_set_dense,
                                       mis_cluster, mis_cluster_dense)
from tgp_tpu_torch.select.lapool import lapool_select, shortest_path_weights
from tgp_tpu_torch.select.topk import (TopkSelect, dense_topk_indices,
                                       dense_topk_select_output, topk_budget,
                                       topk_select_from_scores)


def degree_scorer(batch):
    """Weighted in-degree node score (``[N]``, over the valid edges)."""
    from tgp_tpu_torch.ops.sparse import weighted_degree

    return weighted_degree(batch.receivers, batch.edge_weight,
                           batch.num_nodes, mask=batch.edge_mask)


__all__ = ["SelectOutput", "cluster_to_select_output",
           "compact_select_output", "TopkSelect", "topk_budget",
           "topk_select_from_scores", "dense_topk_indices",
           "dense_topk_select_output", "EdgeContractionSelect", "matching",
           "maximal_matching", "maximal_matching_dense", "graclus_select",
           "KMISSelect", "maximal_independent_set",
           "maximal_independent_set_dense", "mis_cluster",
           "mis_cluster_dense", "lapool_select", "shortest_path_weights",
           "degree_scorer"]
