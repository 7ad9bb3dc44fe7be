"""Nearest-neighbour video retrieval CLI (root ``video_retrieval.py``, the
same flags):

    python -m selavi_tpu_torch.cli.video_retrieval --dataset ucf101 \
        --root_dir data/ucf101 --data_path data/ucf101 \
        --weights_path runs/x/checkpoint.pth --task v-v

Task ``v-v`` compares the pooled truncated video tower's features;
``v-a``, ``a-v`` and ``a-a`` take both modalities' 512-d GAP features from
one eval-mode forward (``train/step.py::encode``, fp32). Features are
averaged per video over ``--train_clips_per_video`` clips, then
Recall@{1,5,10,20,50} is printed and returned. ``--feature_cache`` keeps
the features in a pickle that either package reads: a hit skips the
dataset and the model, a cache of another feature kind is recomputed.
``--weights_path`` takes a port ``checkpoint.pth`` or ``ckp-*.pth``
(``train/checkpoint.py::load_model_parameters``). Runs on the card unless
``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from selavi_tpu_torch.config import bool_flag
from selavi_tpu_torch.data.factory import audio_cfg_from_args
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.eval.retrieval import (
    average_features,
    collect_features,
    make_retrieval_encode_fn,
    retrieval,
    select_task_features,
)
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train.checkpoint import load_model_parameters


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Video retrieval")
    parser.register("type", "bool", bool_flag)
    parser.add_argument("--dataset", default="ucf101", type=str)
    parser.add_argument("--root_dir", type=str, default="/path/to/dataset")
    parser.add_argument("--data_path", type=str, default="datasets/data")
    parser.add_argument("--fold", default=1, type=int)
    parser.add_argument("--weights_path", default="", type=str)
    parser.add_argument("--clip_len", default=32, type=int)
    parser.add_argument("--steps_bet_clips", default=1, type=int)
    parser.add_argument("--train_clips_per_video", default=10, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--workers", default=8, type=int)
    parser.add_argument("--headcount", default=10, type=int)
    parser.add_argument("--num_clusters", default=309, type=int)
    parser.add_argument("--pool_op", default="max", choices=["max", "avg"])
    parser.add_argument("--norm_feats", default="True", type="bool")
    parser.add_argument("--task", default="v-v", type=str)
    parser.add_argument("--feature_cache", default=None, type=str,
                        help="optional pickle cache path for features")
    parser.add_argument("--num_data_samples", default=None, type=int)
    parser.add_argument("--tpu_aligned_midplanes", type="bool",
                        default="False")
    # audio-frontend config for PCM-emitting datasets (must match the
    # flags the checkpoint was trained with; defaults mirror get_clusters)
    parser.add_argument("--aud_sample_rate", type=int, default=48000)
    parser.add_argument("--aud_spec_type", type=int, default=2)
    parser.add_argument("--z_normalize", type="bool", default="True")
    parser.add_argument("--dual_data", type="bool", default="False",
                        help="checkpoint was trained with --dual_data "
                             "(2-channel audio stem); eval specs are "
                             "duplicated across both channels")
    return parser.parse_args(argv)


def build_datasets(args):
    """(train, test) splits; audio is decoded only for the audio tasks."""
    need_audio = args.task != "v-v"
    if args.dataset == "synthetic":
        from selavi_tpu_torch.data.synthetic import SyntheticAVDataset

        n = args.num_data_samples or 64
        return (SyntheticAVDataset(num_samples=n, num_frames=args.clip_len,
                                   mode="train"),
                SyntheticAVDataset(num_samples=n, num_frames=args.clip_len,
                                   mode="test", seed=1))
    from selavi_tpu_torch.data.dataset import AVideoDataset

    common = dict(ds_name=args.dataset, root_dir=args.root_dir,
                  num_frames=args.clip_len, sample_rate=args.steps_bet_clips,
                  fold=args.fold, decode_audio=need_audio,
                  path_to_data_dir=args.data_path)
    train = AVideoDataset(mode="train",
                          num_train_clips=args.train_clips_per_video,
                          train_crop_size=112, **common)
    test = AVideoDataset(mode="test", num_spatial_crops=1,
                         num_ensemble_views=args.train_clips_per_video,
                         test_crop_size=112, **common)
    return train, test


def feature_kind(args) -> str:
    """The cache's ``_video_feature_kind``: audio tasks keep 512-d GAP
    features, v-v the pooled tower, and --norm_feats is baked in."""
    need_audio = args.task != "v-v"
    return (("gap" if need_audio else f"pooled:{args.pool_op}")
            + f"|norm:{bool(args.norm_feats)}")


def load_cache(args):
    """The cached features, or None when there is no cache or it holds
    another feature kind."""
    if not (args.feature_cache and os.path.isfile(args.feature_cache)):
        return None
    with open(args.feature_cache, "rb") as fh:
        feats = pickle.load(fh)
    cached_kind = feats.pop("_video_feature_kind", None)
    if cached_kind != feature_kind(args):
        print(f"cache holds '{cached_kind}' video features but task "
              f"{args.task} needs '{feature_kind(args)}'; recomputing")
        return None
    print(f"loaded cached features from {args.feature_cache}")
    return feats


def compute_features(args, device) -> dict:
    """``{"train", "val"[, "train_audio", "val_audio"]}``, each
    ``(features, vid_indices, labels)`` averaged per video."""
    need_audio = args.task != "v-v"
    train_ds, test_ds = build_datasets(args)
    audio_channels = 2 if args.dual_data else 1
    model = load_model(
        headcount=args.headcount, num_classes=args.num_clusters,
        midplanes_mode="aligned" if args.tpu_aligned_midplanes else "parity",
        device=device, audio_channels=audio_channels)
    if args.weights_path and args.weights_path != "None":
        load_model_parameters(model, args.weights_path)
    encode_fn = joint_encode = None
    if need_audio:
        audio_cfg = audio_cfg_from_args(args)

        def joint_encode(video, audio):
            return steps.encode(model, video, audio, augment=False,
                                compute_dtype=torch.float32,
                                audio_cfg=audio_cfg,
                                audio_channels=audio_channels)
    else:
        encode_fn = make_retrieval_encode_fn(model, pool_op=args.pool_op)

    feats = {}
    for split, ds in (("train", train_ds), ("val", test_ds)):
        loader = DataLoader(ds, batch_size=args.batch_size, shuffle=False,
                            drop_last=False, num_workers=args.workers,
                            device=device)
        try:
            out = collect_features(encode_fn, decode_wire_batches(loader),
                                   joint_encode_fn=joint_encode)
        finally:
            loader.close()
        f, v, lab = out[:3]
        feats[split] = average_features(f, v, lab, norm_feats=args.norm_feats)
        if need_audio:
            feats[split + "_audio"] = average_features(
                out[3], v, lab, norm_feats=args.norm_feats)
    return feats


def main(argv=None, device=None):
    """Print and return the recalls ``{k: percent}``."""
    args = parse_args(argv)
    device = resolve_device(device)
    feats = load_cache(args)
    if feats is None:
        feats = compute_features(args, device)
        if args.feature_cache:
            # the whole dict (the *_audio entries too) and its kind
            with open(args.feature_cache, "wb") as fh:
                pickle.dump(dict(feats, _video_feature_kind=feature_kind(
                    args)), fh)
    return report(args, feats, device)


def report(args, feats: dict, device) -> dict:
    tf, _, tl = feats["train"]
    vf, _, vl = feats["val"]
    ta = feats.get("train_audio", (None,))[0]
    va = feats.get("val_audio", (None,))[0]
    feat_train, feat_val = select_task_features(args.task, tf, ta, vf, va)
    recalls = retrieval(feat_train, tl, feat_val, vl, device=device)
    print({f"R@{k}": round(v, 2) for k, v in recalls.items()})
    return recalls


if __name__ == "__main__":
    main()
