"""Cluster-assignment dump: every head's logits over a whole dataset, in a
pickle (``selavi_tpu/eval/get_clusters.py``).

``dump_cluster_matrices`` runs the model in eval mode (center crop, no
jitter) over the dataset, scatters the pooled features and the labels by
sample index, applies every head and writes ``[[PS_v_h] * H, labels,
[PS_a_h] * H]`` as torch tensors: the schema of the reference's
``clustering_metrics.py`` and of the JAX package's dumps, so each package
reads the other's. Under a process group each rank encodes its stride of
the dataset, the features and labels are gathered on every rank and rank
0 writes the pickle. ``evaluate_dump`` is the reference ``k_means`` report
over such a file (``eval/clustering.py``).
"""

from __future__ import annotations

import logging
import pickle
from typing import Callable, Iterator

import numpy as np
import torch

from selavi_tpu_torch.data.loader import batch_valid
from selavi_tpu_torch.device import DeviceLike, resolve_device
from selavi_tpu_torch.eval.clustering import (
    best_head_labels,
    clustering_report,
    head_labels,
)
from selavi_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)


def dump_cluster_matrices(
    encode_fn: Callable,
    head_logits_fn: Callable,
    batch_iter: Iterator[dict],
    n: int,
    out_path: str,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns ``(PS_v [H,N,K], labels [N], PS_a [H,N,K])`` as numpy and
    writes them to ``out_path`` in the reference schema (per-head float32
    tensors, int64 labels). ``encode_fn(video, audio) -> (feat_v,
    feat_a)`` gives eval-mode pooled features, ``head_logits_fn(feats,
    modality) -> [H, N, K]`` applies every head; the accumulators, as
    wide as those features, live on ``device`` (the card unless the caller names another). Under a process
    group every rank returns the whole dump and rank 0 writes it."""
    from selavi_tpu_torch.selflabel.engine import aggregate_features

    device = resolve_device(device)
    labels_dev = torch.zeros(n, dtype=torch.int64, device=device)
    rows = []  # (index, label, valid) of every batch of this rank

    def with_labels(batches):
        for batch in batches:
            idx = torch.as_tensor(batch["index"], dtype=torch.long).to(device)
            rows.append((idx, torch.as_tensor(batch["label"]).to(
                device, torch.int64), batch_valid(batch, device)))
            yield batch

    feats_v, feats_a = aggregate_features(
        encode_fn, with_labels(batch_iter), n, device)
    idx, labels, valid = (torch.cat(c) for c in zip(*rows))
    labels_dev[mesh.gather_rows(idx, valid)] = mesh.gather_rows(labels, valid)
    labels = labels_dev.cpu().numpy()
    ps_v = head_logits_fn(feats_v, "v").float().cpu().numpy()
    ps_a = head_logits_fn(feats_a, "a").float().cpu().numpy()

    def wrap(a):
        return torch.from_numpy(np.array(a, copy=True))

    if mesh.world()[0] == 0:
        payload = [[wrap(m) for m in ps_v], wrap(labels),
                   [wrap(m) for m in ps_a]]
        with open(out_path, "wb") as f:
            pickle.dump(payload, f)
        logger.info("dumped cluster matrices to %s", out_path)
    return ps_v, labels, ps_a


def evaluate_dump(path: str, ncentroids: int,
                  use_all_heads: bool = True) -> dict:
    """The reference ``k_means`` report over a dump written by this module
    or by the JAX package: the best head's labels by NMI (or head 0's),
    printed and returned."""
    with open(path, "rb") as f:
        ps = pickle.load(f)
    ps_v_heads = np.stack([np.asarray(m) for m in ps[0]])
    labels = np.asarray(ps[1])
    ps_a_heads = np.stack([np.asarray(m) for m in ps[2]])
    if use_all_heads:
        preds, best_h = best_head_labels(ps_v_heads, ps_a_heads, labels)
        logger.info("best head: %d", best_h)
    else:
        preds = head_labels(ps_v_heads[0], ps_a_heads[0])
    report = clustering_report(preds, labels, ncentroids)
    for k, v in report.items():
        print(f"{k}: {v:.4f}")
    return report
