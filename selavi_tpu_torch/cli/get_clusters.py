"""Cluster-assignment dump CLI (root ``get_clusters.py``, the same flags):
load a port checkpoint, run center-crop fp32 inference over the dataset and
dump ``[PS_v_heads, labels, PS_a_heads]``.

    python -m selavi_tpu_torch.cli.get_clusters --ds_name vggsound ... \
        --weights_path runs/x/checkpoint.pth --output_path ps.pkl

``--weights_path`` takes a port ``checkpoint.pth`` or ``ckp-*.pth``; a
reference-layout ``.pth`` or ``.pth.tar`` (the reference's own, or a JAX
run exported by ``export_torch.py``), imported strictly into the
architecture of the flags (``train/torch_import.py``), as root
``get_clusters.py`` takes it; or ``None`` for a random init. A JAX
``*.msgpack`` is refused (``train/checkpoint.py::load_model_parameters``).
Runs on the card unless ``main`` is given ``device="cpu"``. Under
``torchrun --nproc_per_node N`` each rank encodes its stride of the
dataset, ``--batch_size`` per process, and rank 0 writes the dump.
"""

from __future__ import annotations

import argparse

import torch

from selavi_tpu_torch.config import bool_flag
from selavi_tpu_torch.data.dataset import NUM_CLUSTERS
from selavi_tpu_torch.data.factory import (
    add_dataset_flags,
    audio_cfg_from_args,
    build_dataset,
    example_shapes,
)
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.eval.get_clusters import dump_cluster_matrices
from selavi_tpu_torch.models.av_model import VIDEO_ARCHS, load_model
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS
from selavi_tpu_torch.parallel.dist import distributed
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train import torch_import
from selavi_tpu_torch.train.checkpoint import load_model_parameters


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Get cluster assignments")
    parser.register("type", "bool", bool_flag)
    add_dataset_flags(parser)
    parser.add_argument("--weights_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="ps_matrices.pkl")
    parser.add_argument("--headcount", type=int, default=10)
    parser.add_argument("--vid_base_arch", type=str, default="r2plus1d_18",
                        choices=sorted(VIDEO_ARCHS))
    parser.add_argument("--aud_base_arch", type=str, default="resnet9",
                        choices=sorted(AUDIO_ARCHS),
                        help="audio tower arch the checkpoint was trained "
                             "with")
    parser.add_argument("--use_mlp", type="bool", default="True")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--tpu_aligned_midplanes", type="bool",
                        default="False",
                        help="set to true for checkpoints trained with "
                             "MXU-aligned midplane widths")
    parser.add_argument("--dual_data", type="bool", default="False",
                        help="checkpoint was trained with --dual_data "
                             "(2-channel audio stem); eval specs are "
                             "duplicated across both channels")
    return parser.parse_args(argv)


def load_weights(model, path: str):
    """A reference-layout ``.pth``/``.pth.tar`` through the import, any
    other file through ``load_model_parameters``."""
    if (path.endswith((".pth", ".pth.tar"))
            and torch_import.read_reference_state_dict(path) is not None):
        return torch_import.import_reference_checkpoint(model, path)
    return load_model_parameters(model, path)


def main(argv=None, device=None):
    """Write the dump; returns ``(ps_v, labels, ps_a)`` as numpy."""
    args = parse_args(argv)
    with distributed(args, device) as (rank, world_size):
        return _dump(args, resolve_device(device), rank, world_size)


def _dump(args, device, rank, world_size):
    dataset = build_dataset(args, mode=args.mode, eval_mode=True)
    # eval datasets yield single clips; a dual_data checkpoint's stem takes
    # 2 channels, and encode tiles the spectrogram onto them
    audio_channels = 2 if args.dual_data else example_shapes(
        args, dataset)[1][-1]
    model = load_model(
        vid_base_arch=args.vid_base_arch,
        num_frames=args.num_frames,
        crop_size=args.train_crop_size,
        aud_base_arch=args.aud_base_arch,
        use_mlp=args.use_mlp,
        headcount=args.headcount,
        num_classes=args.mlp_dim or NUM_CLUSTERS.get(args.ds_name, 309),
        midplanes_mode="aligned" if args.tpu_aligned_midplanes else "parity",
        device=device,
        audio_channels=audio_channels,
    )
    if args.weights_path != "None":  # None: random init
        load_weights(model, args.weights_path)
    audio_cfg = audio_cfg_from_args(args)

    def encode_fn(video, audio):
        return steps.encode(model, video, audio, augment=False,
                            compute_dtype=torch.float32, audio_cfg=audio_cfg,
                            audio_channels=audio_channels)

    def head_logits_fn(feats, modality):
        return steps.head_logits(model, feats, modality, torch.float32)

    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False,
                        drop_last=False, num_workers=args.workers,
                        device=device, rank=rank, world_size=world_size)
    try:
        out = dump_cluster_matrices(
            encode_fn, head_logits_fn, decode_wire_batches(loader),
            len(dataset), args.output_path, device=device)
    finally:
        loader.close()
    if rank == 0:
        print(f"wrote {args.output_path}")
    return out


if __name__ == "__main__":
    main()
