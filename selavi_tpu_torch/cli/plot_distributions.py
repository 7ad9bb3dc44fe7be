"""Cluster-size distribution plots (root ``plot_distributions.py``, the
same flags): the sorted cluster sizes of the self-labels of one or more
port checkpoints, beside the target marginals stored in each.

    python -m selavi_tpu_torch.cli.plot_distributions \
        --checkpoints runs/x/checkpoint.pth --output distributions.png

Checkpoints are read with ``torch.load(weights_only=True)``; matplotlib is
needed only here and is imported when the plot is drawn.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def load_selflabels(ckpt_path: str):
    """``(selflabels [N, H], target marginals [H, K] or None)`` of a port
    checkpoint."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    dists = payload["dist"]["dists"]
    return (payload["selflabels"].numpy(),
            None if dists is None else dists.numpy())


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Plot self-label cluster-size distributions")
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="checkpoint.pth paths")
    parser.add_argument("--names", nargs="+", default=None)
    parser.add_argument("--head", type=int, default=0)
    parser.add_argument("--output", default="distributions.png")
    args = parser.parse_args(argv)

    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plot_distributions draws with matplotlib, which this machine "
            "does not have") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = args.names or [f"ckpt{i}" for i in range(len(args.checkpoints))]
    plt.figure(figsize=(8, 5))
    for path, name in zip(args.checkpoints, names):
        labels, dists = load_selflabels(path)
        counts = np.bincount(labels[:, args.head])
        plt.plot(np.sort(counts)[::-1], label=name)
        if dists is not None:
            plt.plot(np.sort(dists[args.head])[::-1], "--",
                     label=f"{name} target")
    plt.xlabel("cluster (sorted by size)")
    plt.ylabel("size")
    plt.legend()
    plt.tight_layout()
    plt.savefig(args.output, dpi=120)
    plt.close()
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
