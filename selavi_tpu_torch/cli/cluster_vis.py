"""Cluster-browser export CLI (``python -m selavi_tpu.eval.cluster_vis``,
the same flags):

    python -m selavi_tpu_torch.cli.cluster_vis --weights_path \
        runs/x/checkpoint.pth <the run's dataset flags> --out_dir out

writes ``{out_dir}/clusters.js`` from a port checkpoint's self-labels over
the dataset rebuilt from the flags (eval mode, ``--mode`` split) for the
static page in ``cluster_vis/``. Runs on the host only.
"""

from __future__ import annotations

import argparse
import os

from selavi_tpu_torch.config import bool_flag
from selavi_tpu_torch.data.factory import add_dataset_flags, build_dataset
from selavi_tpu_torch.eval.cluster_vis import export_from_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export cluster-browser data from a checkpoint")
    p.register("type", "bool", bool_flag)
    add_dataset_flags(p)  # incl. --mlp_dim (synthetic class count)
    p.add_argument("--weights_path", required=True)
    p.add_argument("--head", type=int, default=0)
    p.add_argument("--out_dir", default="cluster_vis/data")
    p.add_argument("--meta_classes", default=None,
                   help="optional meta-classes.json path")
    return p.parse_args(argv)


def main(argv=None):
    """Write ``clusters.js``; returns its payload (one entry a cluster)."""
    args = parse_args(argv)
    dataset = build_dataset(args, mode=args.mode, eval_mode=True)
    clusters = export_from_checkpoint(
        args.weights_path, dataset, out_dir=args.out_dir, head=args.head,
        meta_classes_path=args.meta_classes)
    print(f"wrote {os.path.join(args.out_dir, 'clusters.js')} "
          f"({len(clusters)} clusters)")
    return clusters


if __name__ == "__main__":
    main()
