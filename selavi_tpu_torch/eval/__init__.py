from selavi_tpu_torch.eval.cluster_vis import export_from_checkpoint
from selavi_tpu_torch.eval.clustering import (
    best_head_labels,
    cluster_accuracy,
    clustering_report,
    entropy_purity,
    hungarian_match,
)
from selavi_tpu_torch.eval.finetune import FinetuneConfig, FinetuneModel
from selavi_tpu_torch.eval.get_clusters import (
    dump_cluster_matrices,
    evaluate_dump,
)
from selavi_tpu_torch.eval.retrieval import (
    average_features,
    collect_features,
    retrieval,
)

__all__ = [
    "clustering_report",
    "cluster_accuracy",
    "hungarian_match",
    "best_head_labels",
    "entropy_purity",
    "dump_cluster_matrices",
    "evaluate_dump",
    "average_features",
    "collect_features",
    "retrieval",
    "FinetuneModel",
    "FinetuneConfig",
    "export_from_checkpoint",
]
