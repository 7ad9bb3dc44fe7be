"""Action-recognition finetuning CLI (root ``finetune_video.py``, the same
flags and defaults):

    python -m selavi_tpu_torch.cli.finetune_video --dataset ucf101 \
        --root_dir data/ucf101/videos --data_path data/ucf101 \
        --weights_path runs/x/checkpoint.pth --output_dir runs/ft

loops the folds of ``--fold`` and prints the mean best video acc@1/acc@5
(``K-Fold (...)``). ``train.log`` goes to ``--output_dir``, and TensorBoard
events to ``{output_dir}/tensorboard`` where tensorboardX imports.
``--weights_path`` takes a port ``checkpoint.pth`` or ``ckp-*.pth``.
``--ckpt_epoch``, ``--pretrained``, ``--test_time_cj``, ``--start_epoch``,
``--vid_base_arch`` and ``--aud_base_arch`` are parsed and not read, as in
JAX. Runs on the card unless ``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os

from selavi_tpu_torch.config import bool_flag
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.eval.finetune_runner import run_folds
from selavi_tpu_torch.utils.logger import create_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Finetuning")
    parser.register("type", "bool", bool_flag)

    # DATA
    parser.add_argument("--dataset", default="ucf101", type=str,
                        choices=["kinetics", "vggsound", "kinetics_sound",
                                 "ave", "ucf101", "hmdb51", "synthetic"])
    parser.add_argument("--root_dir", type=str, default="/path/to/dataset")
    parser.add_argument("--data_path", type=str, default="datasets/data")
    parser.add_argument("--fold", default="1,2,3", type=str)
    parser.add_argument("--clip_len", default=32, type=int)
    parser.add_argument("--augtype", default=1, type=int)
    parser.add_argument("--colorjitter", default="True", type="bool")
    parser.add_argument("--steps_bet_clips", default=1, type=int)
    parser.add_argument("--num_data_samples", default=None, type=int)
    parser.add_argument("--train_clips_per_video", default=10, type=int)
    parser.add_argument("--val_clips_per_video", default=10, type=int)
    parser.add_argument("--num_spatial_crops", default=3, type=int)
    parser.add_argument("--test_time_cj", default="False", type="bool")
    parser.add_argument("--workers", default=0, type=int)

    # MODEL
    parser.add_argument("--weights_path", default="", type=str)
    parser.add_argument("--ckpt_epoch", default="0", type=str)
    parser.add_argument("--vid_base_arch", default="r2plus1d_18")
    parser.add_argument("--aud_base_arch", default="resnet9")
    parser.add_argument("--pretrained", default="False", type="bool")
    parser.add_argument("--use_mlp", default="True", type="bool")
    parser.add_argument("--headcount", default=10, type=int)
    parser.add_argument("--num_clusters", default=309, type=int)

    # FINETUNE
    parser.add_argument("--feature_extract", default="False", type="bool")
    parser.add_argument("--use_dropout", default="False", type="bool")
    parser.add_argument("--use_bn", default="False", type="bool")
    parser.add_argument("--use_l2_norm", default="False", type="bool")

    # TRAINING
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--epochs", default=12, type=int)
    parser.add_argument("--optim_name", default="sgd",
                        choices=["sgd", "adam"])
    parser.add_argument("--head_lr", default=0.0025, type=float)
    parser.add_argument("--base_lr", default=0.00025, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight_decay", default=0.005, type=float)
    parser.add_argument("--wd_base", default=5e-3, type=float)
    parser.add_argument("--use_scheduler", default="True", type="bool")
    parser.add_argument("--lr_warmup_epochs", default=2, type=int)
    parser.add_argument("--lr_milestones", default="6,10", type=str)
    parser.add_argument("--lr_gamma", default=0.05, type=float)

    # LOGGING / CHECKPOINTING
    parser.add_argument("--output_dir", default=".", type=str)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--test_only", type="bool", default="False")
    parser.add_argument("--compute_dtype", default="bfloat16", type=str)
    parser.add_argument("--tpu_aligned_midplanes", type="bool",
                        default="False")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Run the folds; returns ``run_folds``' result dict."""
    args = parse_args(argv)
    device = resolve_device(device)
    os.makedirs(args.output_dir, exist_ok=True)
    create_logger(os.path.join(args.output_dir, "train.log"), rank=0)

    writer = None
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(args.output_dir, "tensorboard"))
    except ImportError:
        pass
    try:
        result = run_folds(args, writer=writer, device=device)
    finally:
        if writer is not None:
            writer.close()
    print(f"{len(result['folds'])}-Fold ({args.dataset}): "
          f"Vid Acc@1 {result['avg_acc1']:.3f}, "
          f"Vid Acc@5 {result['avg_acc5']:.3f}")
    return result


if __name__ == "__main__":
    main()
