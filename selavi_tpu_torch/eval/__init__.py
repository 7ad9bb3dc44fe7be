from selavi_tpu_torch.eval.clustering import (
    best_head_labels,
    cluster_accuracy,
    clustering_report,
    entropy_purity,
    hungarian_match,
)
from selavi_tpu_torch.eval.get_clusters import (
    dump_cluster_matrices,
    evaluate_dump,
)

__all__ = [
    "clustering_report",
    "cluster_accuracy",
    "hungarian_match",
    "best_head_labels",
    "entropy_purity",
    "dump_cluster_matrices",
    "evaluate_dump",
]
