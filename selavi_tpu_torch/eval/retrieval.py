"""Nearest-neighbour video retrieval (``selavi_tpu/eval/retrieval.py``).

* ``make_retrieval_encode_fn``: the video tower truncated before the GAP,
  its map max- or average-pooled over 2x2x2 windows (VALID, floor) and
  flattened channels-last, as JAX flattens ``[B, t, h, w, C]``, so the
  feature vectors and the feature caches match JAX's element for element;
* ``collect_features`` over a split, rows deduplicated by the batch
  ``index`` (under a process group gathered from every rank first, the
  wrap-padding dropped); ``average_features``: per-clip L2 norm,
  per-video mean;
* ``retrieval``: Recall@{1,5,10,20,50}, a hit being the query's class among
  its k nearest train videos. JAX asks sklearn's ``NearestNeighbors(50)``
  (exact Euclidean kNN); the card machine has no sklearn, so
  ``nearest_neighbors`` solves the same kNN exactly with torch on the
  features' device.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from selavi_tpu_torch.data.loader import batch_valid
from selavi_tpu_torch.device import DeviceLike, resolve_device
from selavi_tpu_torch.ops.preprocess import normalize_video
from selavi_tpu_torch.parallel import mesh
from selavi_tpu_torch.train.step import autocast

logger = logging.getLogger(__name__)

RECALL_THRESHOLDS = (1, 5, 10, 20, 50)
POOL_WINDOW = (2, 2, 2)
# Bytes of fp64 distances held at once: queries are solved in chunks of
# rows so that one chunk's [rows, N_train] matrix stays under this.
KNN_CHUNK_BYTES = 1 << 28


def make_retrieval_encode_fn(model, pool_op: str = "max",
                             compute_dtype: torch.dtype = torch.float32
                             ) -> Callable:
    """``encode(video_u8 [B,T,H,W,3]) -> [B, D_flat]`` fp32: normalize, the
    eval-mode feature map ``[B, t, h, w, C]`` (C the tower's width: 512
    for R(2+1)D-18, 768 for TimeSformer's patch tokens), a 2x2x2 max or
    average pool, flattened channels-last."""
    if pool_op not in ("max", "avg"):
        raise ValueError(f"pool_op {pool_op!r}: max or avg")

    @torch.no_grad()
    def encode(video_u8):
        model.eval()
        video = normalize_video(video_u8)
        with autocast(video.device, compute_dtype):
            fmap = model.video_feature_map(video)  # fp32
        if any(s < w for s, w in zip(fmap.shape[1:4], POOL_WINDOW)):
            raise ValueError(
                f"feature map {tuple(fmap.shape[1:4])} smaller than pool "
                f"window {POOL_WINDOW}: use >=16 frames and >=64px crops "
                "(reference retrieval uses clip_len 32 @ 112px)")
        x = fmap.permute(0, 4, 1, 2, 3)  # [B, C, t, h, w]
        pool = F.max_pool3d if pool_op == "max" else F.avg_pool3d
        pooled = pool(x, POOL_WINDOW, POOL_WINDOW)
        return pooled.permute(0, 2, 3, 4, 1).reshape(
            pooled.shape[0], -1).float()

    return encode


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def collect_features(
    encode_fn: Optional[Callable],
    batch_iter: Iterator[dict],
    audio_encode_fn: Optional[Callable] = None,
    joint_encode_fn: Optional[Callable] = None,
):
    """Run the encoder(s) over a split; returns ``(features, vid_indices,
    labels[, audio_features])``, one row per clip, deduplicated and sorted
    by the batch ``index`` where batches carry one.
    ``joint_encode_fn(video, audio) -> (feat_v, feat_a)`` encodes both
    modalities in one forward; otherwise ``encode_fn(video)`` (and
    ``audio_encode_fn(audio)``) run separately. Under a process group
    every rank returns the rows of every rank."""
    feats, vids, labels, afeats, indices, valid = [], [], [], [], [], []
    for batch in batch_iter:
        audio = batch.get("audio", batch.get("audio_pcm"))
        if joint_encode_fn is not None:
            fv, fa = joint_encode_fn(batch["video"], audio)
            feats.append(_host(fv))
            afeats.append(_host(fa))
        else:
            feats.append(_host(encode_fn(batch["video"])))
            if audio_encode_fn is not None:
                afeats.append(_host(audio_encode_fn(audio)))
        vids.append(_host(batch["vid_idx"]))
        labels.append(_host(batch["label"]))
        valid.append(batch_valid(batch))
        if "index" in batch:
            indices.append(_host(batch["index"]))
    columns = [np.concatenate(c) for c in (feats, vids, labels, afeats,
                                           indices) if c]
    if mesh.world()[2] is not None:
        keep = torch.cat(valid)
        columns = [mesh.gather_rows(torch.from_numpy(c), keep).numpy()
                   for c in columns]
    out = tuple(columns[:3])
    afeats = columns[3:3 + bool(afeats)]
    if indices:
        _, first = np.unique(columns[-1], return_index=True)
        out = tuple(a[first] for a in out)
        afeats = [a[first] for a in afeats]
    return out + tuple(afeats)


def average_features(features: np.ndarray, vid_indices: np.ndarray,
                     labels: np.ndarray, norm_feats: bool = True):
    """Per-clip L2 norm, then the mean over each video's clips, videos in
    order of first appearance."""
    if norm_feats:
        features = features / np.maximum(
            np.sqrt((features ** 2).sum(1, keepdims=True)), 1e-12)
    feat_dict = defaultdict(list)
    label_dict = {}
    for f, v, lab in zip(features, vid_indices, labels):
        feat_dict[int(v)].append(f)
        label_dict[int(v)] = int(lab)
    avg_feats, avg_vids, avg_labels = [], [], []
    for vid, fl in feat_dict.items():
        avg_feats.append(np.mean(np.stack(fl), axis=0))
        avg_vids.append(vid)
        avg_labels.append(label_dict[vid])
    return np.stack(avg_feats), np.asarray(avg_vids), np.asarray(avg_labels)


def select_task_features(task: str, train_v, train_a, val_v, val_a):
    """``(train, val)`` feature sets of a task: the query modality first,
    the gallery's second (``a-v``: audio queries, video gallery)."""
    if task not in ("v-v", "v-a", "a-v", "a-a"):
        raise ValueError(f"task {task!r}: v-v, v-a, a-v or a-a")
    if task != "v-v" and (train_a is None or val_a is None):
        raise ValueError(f"task {task} needs audio features")
    feat_val = val_v if task.startswith("v") else val_a
    feat_train = train_v if task.endswith("v") else train_a
    return feat_train, feat_val


def nearest_neighbors(train_features: np.ndarray, val_features: np.ndarray,
                      k: int, device: DeviceLike = None) -> np.ndarray:
    """Indices ``[N_val, k]`` of each query's k nearest train rows by
    Euclidean distance, nearest first, solved exactly on ``device`` (the
    card unless the caller names another).

    The squared distances are ``|a|^2 + |b|^2 - 2 a.b`` in fp64. In fp32
    that expansion cancels to ~1e-7 of ``|a|^2``, which reorders near-ties
    among v-v's 9216-d features (torch.cdist switches to it above 25 rows);
    in fp64 the error is ~1e-16, below the fp32 features' own resolution,
    and one fp64 product of the UCF-101 split is a fraction of a second on
    the card. sklearn upcasts fp32 features to fp64 for the same reason."""
    device = resolve_device(device)
    train = torch.as_tensor(np.asarray(train_features), device=device,
                            dtype=torch.float64)
    val = torch.as_tensor(np.asarray(val_features), device=device,
                          dtype=torch.float64)
    train_sq = (train * train).sum(1)
    rows = max(1, KNN_CHUNK_BYTES // (8 * max(len(train), 1)))
    out = []
    for s in range(0, len(val), rows):
        q = val[s:s + rows]
        d2 = (q * q).sum(1, keepdim=True) + train_sq[None, :] - 2.0 * (
            q @ train.T)
        out.append(torch.topk(d2, k, dim=1, largest=False,
                              sorted=True).indices)
    return torch.cat(out).cpu().numpy()


def retrieval(train_features: np.ndarray, train_labels: np.ndarray,
              val_features: np.ndarray, val_labels: np.ndarray,
              thresholds=RECALL_THRESHOLDS, device: DeviceLike = None
              ) -> dict:
    """Recall@k in percent: the share of queries whose class is among
    their k nearest train videos. One kNN solve at the largest k (the
    lists nest); with fewer train rows than the largest threshold, the
    thresholds above the row count are dropped (JAX's trimming)."""
    max_k = min(max(thresholds), len(train_features))
    thresholds = [k for k in thresholds if k <= max_k] or [max_k]
    indices = nearest_neighbors(train_features, val_features, max_k, device)
    neighbor_labels = np.asarray(train_labels)[indices]  # [N_val, max_k]
    recalls = {}
    for k in thresholds:
        hit = (neighbor_labels[:, :k] == np.asarray(val_labels)[:, None]
               ).any(axis=1)
        recalls[k] = float(100.0 * hit.mean())
        logger.info("Recall @ %d: %.2f", k, recalls[k])
    return recalls
