"""Training meters and accuracy helpers: the port's numpy copy of
``selavi_tpu/utils/meters.py``'s ``AverageMeter`` (the Trainer's and the
finetune loop's), ``topk_accuracy`` and ``aggregate_video_accuracy``."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def topk_accuracy(output: np.ndarray, target: np.ndarray, topk=(1,)):
    """Precision@k in percent. output [B, K] scores, target [B] labels.
    ``argsort(-output)`` breaks ties as the JAX package does."""
    maxk = max(topk)
    pred = np.argsort(-output, axis=1)[:, :maxk]  # [B, maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def aggregate_video_accuracy(softmaxes: dict, labels: dict, topk=(1,)):
    """Video-level accuracy: ``softmaxes[video_id]`` is a list of [K] clip
    scores, mean-aggregated per video before top-k."""
    video_ids = list(softmaxes.keys())
    output = np.stack(
        [np.mean(np.stack(softmaxes[v]), axis=0) for v in video_ids])
    target = np.array([labels[v] for v in video_ids])
    return topk_accuracy(output, target, topk)
