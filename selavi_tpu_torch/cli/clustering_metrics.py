"""Clustering-quality CLI over a get_clusters dump (root
``clustering_metrics.py``, the same flags and pickle schema):

    python -m selavi_tpu_torch.cli.clustering_metrics --path ps.pkl \
        --ncentroids 309

prints nmi, anmi, ari, entropy, purity and accuracy. The metrics are host
numpy (``eval/clustering.py``); nothing runs on a device.
"""

from __future__ import annotations

import argparse

from selavi_tpu_torch.config import bool_flag
from selavi_tpu_torch.eval.get_clusters import evaluate_dump


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Clustering quality metrics")
    parser.register("type", "bool", bool_flag)
    parser.add_argument(
        "--path",
        default="cluster_fit_PS_matrices_scratch_vgg_sound_train.pkl",
        help="path to the get_clusters dump",
    )
    parser.add_argument("--ncentroids", default=309, type=int)
    parser.add_argument("--use_all_heads", default="True", type="bool")
    args = parser.parse_args(argv)
    return evaluate_dump(args.path, args.ncentroids, args.use_all_heads)


if __name__ == "__main__":
    main()
