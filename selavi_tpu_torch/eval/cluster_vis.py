"""Cluster-browser data export (``selavi_tpu/eval/cluster_vis.py``), on the
host in numpy.

A checkpoint's ``selflabels[:, head]`` and the dataset's paths become
per-cluster sample lists, written as ``clusters.js`` for the static page in
``cluster_vis/``: byte for byte what the JAX package writes from the same
labels and dataset. Sample entries are ``(video_id, start_sec, end_sec,
gt_class)``; for YouTube-derived datasets the id embeds as an iframe, for
others it is the file's name.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

# datasets whose files are named '{youtube_id}_{start}_{end}.mp4' under a
# gt-class directory (kinetics_sound files are kinetics files)
YOUTUBE_FILENAME_DATASETS = ("vggsound", "kinetics", "kinetics_sound")


def parse_youtube_filename(path: str):
    """``.../{gt_class}/{youtube_id}_{start}_{end}.mp4`` ->
    ``(youtube_id, start_sec, end_sec)``; the id may hold underscores, so
    the last two fields are the integer clip window. None when the name
    does not end in two integer fields."""
    name = os.path.splitext(os.path.basename(path))[0]
    parts = name.split("_")
    if len(parts) >= 3:
        try:
            return "_".join(parts[:-2]), int(parts[-2]), int(parts[-1])
        except ValueError:
            pass
    return None


def load_meta_classes(path: str) -> dict:
    """meta-classes.json with its class names' spaces turned into the
    underscores of the gt-class directories."""
    with open(path) as f:
        meta = json.load(f)
    return {k.replace(" ", "_"): v for k, v in meta.items()}


def extract_clusters(selflabels: np.ndarray, video_ids: list[str],
                     gt_classes: list[str],
                     starts: Optional[list[float]] = None,
                     ends: Optional[list[float]] = None,
                     head: int = 0) -> dict[int, list[tuple]]:
    """cluster id -> [(video_id, start, end, gt_class), ...]."""
    labels = np.asarray(selflabels)
    if labels.ndim == 2:
        labels = labels[:, head]
    n = len(labels)
    starts = starts or [0.0] * n
    ends = ends or [10.0] * n
    clusters = defaultdict(list)
    for i in range(n):
        clusters[int(labels[i])].append(
            (video_ids[i], float(starts[i]), float(ends[i]), gt_classes[i]))
    return dict(clusters)


def write_clusters_js(clusters: dict[int, list[tuple]], out_path: str,
                      shuffle_seed: int = 0, max_per_cluster: int = 30,
                      meta_classes: Optional[dict] = None):
    """Write ``var clusters = <json>;``: each cluster's samples shuffled
    (one generator over the clusters in id order) and truncated, with its
    size, purity and top classes. Returns the payload."""
    rng = np.random.default_rng(shuffle_seed)
    payload = []
    for cid in sorted(clusters):
        samples = list(clusters[cid])
        rng.shuffle(samples)
        gt = [s[3] for s in samples]
        uniq, counts = np.unique(gt, return_counts=True)
        order = np.argsort(-counts)
        purity = float(counts.max() / counts.sum()) if len(gt) else 0.0
        payload.append({
            "cluster": cid,
            "size": len(samples),
            "purity": round(purity, 4),
            "top_classes": [
                {"name": str(uniq[i]), "count": int(counts[i])}
                for i in order[:5]
            ],
            "samples": [
                {"id": s[0], "start": s[1], "end": s[2], "gt": s[3],
                 "meta": (meta_classes or {}).get(s[3], s[3])}
                for s in samples[:max_per_cluster]
            ],
        })
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("var clusters = ")
        json.dump(payload, f)
        f.write(";\n")
    return payload


def load_selflabels(ckpt_path: str) -> np.ndarray:
    """``selflabels`` [N, H] of a port ``checkpoint.pth`` or ``ckp-*.pth``."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return payload["selflabels"].numpy()


def export_from_checkpoint(ckpt_path: str, dataset,
                           out_dir: str = "cluster_vis/data", head: int = 0,
                           meta_classes_path: Optional[str] = None):
    """A port checkpoint's self-labels over ``dataset`` (rebuilt with the
    training run's flags) -> ``{out_dir}/clusters.js``; returns the
    payload."""
    selflabels = load_selflabels(ckpt_path)
    if len(selflabels) != len(dataset):
        raise ValueError(
            f"checkpoint has {len(selflabels)} selflabel rows but the "
            f"rebuilt dataset has {len(dataset)} samples — the dataset "
            "flags (--ds_name/--num_data_samples/--mlp_dim/--seed/...) "
            "must match the training run")
    idx_to_class = {v: k for k, v in getattr(dataset, "class_to_idx",
                                             {}).items()}
    labels = getattr(dataset, "labels", np.zeros(len(dataset), np.int64))
    gt_classes = [idx_to_class.get(int(lab), str(int(lab)))
                  for lab in labels]
    starts = ends = None
    if hasattr(dataset, "_path_to_videos"):
        paths = [dataset._path_to_videos[i] for i in dataset.valid_indices]
        if getattr(dataset, "ds_name", "") in YOUTUBE_FILENAME_DATASETS:
            # YouTube ids and clip windows, so the page embeds the clip;
            # the gt class is the parent directory
            video_ids, starts, ends, gt_classes = [], [], [], []
            for p in paths:
                parsed = parse_youtube_filename(p)
                if parsed is None:
                    vid, s, e = os.path.splitext(os.path.basename(p))[0], \
                        0.0, 10.0
                else:
                    vid, s, e = parsed
                video_ids.append(vid)
                starts.append(float(s))
                ends.append(float(e))
                gt_classes.append(os.path.basename(os.path.dirname(p)))
        else:
            video_ids = [os.path.splitext(os.path.basename(p))[0]
                         for p in paths]
    else:
        video_ids = [f"sample_{i}" for i in range(len(dataset))]

    meta = None
    if meta_classes_path and os.path.exists(meta_classes_path):
        meta = load_meta_classes(meta_classes_path)
    clusters = extract_clusters(selflabels, video_ids, gt_classes,
                                starts=starts, ends=ends, head=head)
    return write_clusters_js(clusters, os.path.join(out_dir, "clusters.js"),
                             meta_classes=meta)
