"""CLI flag surface: the port's copy of ``selavi_tpu/config.py``.

The port's Trainer reads the same ``args`` namespace as the JAX package's,
so recipes carry over. ``--sk_backend`` also takes the port's own names
(``fused``, ``plain``) beside the JAX ones (``pallas``, ``xla``), which
mean the same backends here. Flags for paths the port does not run yet (the
mesh's model axis) are kept so that one command line serves both
packages; the Trainer refuses a value other than their default
(``train/loop.py::UNPORTED_FLAGS``).
"""

from __future__ import annotations

import argparse


def bool_flag(v: str) -> bool:
    v = v.lower()
    if v in ("yes", "true", "t", "1", "on"):
        return True
    if v in ("no", "false", "f", "0", "off"):
        return False
    raise argparse.ArgumentTypeError(
        "Boolean argument needs to be true or false. Instead, it is %s." % v
    )


def parse_arguments() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SeLaVi-TPU self-supervised audio-visual labeling"
    )
    parser.register("type", "bool", bool_flag)

    # #### data parameters ####
    parser.add_argument("--ds_name", type=str, default="kinetics",
                        choices=["kinetics", "vggsound", "kinetics_sound",
                                 "ave", "ucf101", "hmdb51", "synthetic",
                                 "packed", "folder"],
                        help="name of dataset ('packed': --root_dir points "
                             "at a shard written by scripts/pack_dataset.py; "
                             "'folder': generic {root}/{mode}/{class}/*.mp4 "
                             "tree, e.g. scripts/make_real_media.py output)")
    parser.add_argument("--root_dir", type=str, default="/path/to/dataset",
                        help="root dir of dataset")
    parser.add_argument("--data_path", type=str, default="datasets/data",
                        help="path to store dataset cache files")
    parser.add_argument("--num_data_samples", type=int, default=None,
                        help="number of dataset samples")
    parser.add_argument("--num_frames", type=int, default=30,
                        help="number of frames to sample per clip")
    parser.add_argument("--target_fps", type=int, default=30,
                        help="video fps")
    parser.add_argument("--sample_rate", type=int, default=1,
                        help="rate to sample frames")
    parser.add_argument("--num_train_clips", type=int, default=1,
                        help="number of clips to sample per video")
    parser.add_argument("--train_crop_size", type=int, default=112,
                        help="train crop size")
    parser.add_argument("--test_crop_size", type=int, default=112,
                        help="test crop size")
    parser.add_argument("--colorjitter", type="bool", default="False",
                        help="use color jitter")
    parser.add_argument("--use_grayscale", type="bool", default="False",
                        help="use grayscale augmentation")
    parser.add_argument("--use_gaussian", type="bool", default="False",
                        help="use gaussian augmentation")
    parser.add_argument("--num_sec_aud", type=int, default=1,
                        help="number of seconds of audio")
    parser.add_argument("--aud_sample_rate", type=int, default=48000,
                        help="audio sample rate")
    parser.add_argument("--aud_spec_type", type=int, default=2,
                        help="audio spec type (1: 40 mel bins, 2: 257)")
    parser.add_argument("--use_volume_jittering", type="bool",
                        default="False", help="use volume jittering")
    parser.add_argument("--use_audio_temp_jittering", type="bool",
                        default="False", help="use audio temporal jittering")
    parser.add_argument("--z_normalize", type="bool", default="False",
                        help="z-normalize the audio")
    parser.add_argument("--dual_data", type="bool", default="False",
                        help="sample two clips per video")

    # #### optim parameters ####
    parser.add_argument("--epochs", default=100, type=int,
                        help="number of total epochs to run")
    parser.add_argument("--batch_size", default=16, type=int,
                        help="batch size per device")
    parser.add_argument("--base_lr", default=4.8, type=float,
                        help="base learning rate")
    parser.add_argument("--wd", default=1e-6, type=float, help="weight decay")
    parser.add_argument("--warmup_epochs", default=10, type=int,
                        help="number of warmup epochs")
    parser.add_argument("--use_warmup_scheduler", default="True", type="bool",
                        help="use warmup scheduler")
    parser.add_argument("--use_lr_scheduler", default="False", type="bool",
                        help="use cosine LR scheduler")

    # #### SK parameters ####
    parser.add_argument("--schedulepower", default=1.5, type=float,
                        help="SK schedule power compared to linear")
    parser.add_argument("--nopts", default=100, type=int,
                        help="number of SK re-clusterings over training")
    parser.add_argument("--lamb", default=20, type=int,
                        help="SK entropic regularization lambda")
    parser.add_argument("--dist", default=None, type=int,
                        help="cached marginal state (set internally)")
    parser.add_argument("--diff_dist_every", default="False", type="bool",
                        help="new Gaussian marginal at every SK step")
    parser.add_argument("--diff_dist_per_head", default="True", type="bool",
                        help="different Gaussian marginal per head")

    # #### SeLaVi parameters ####
    parser.add_argument("--ind_groups", default=1, type=int,
                        help="number of independent head groups")
    parser.add_argument("--gauss_sd", default=0.1, type=float,
                        help="Gaussian marginal stddev")
    parser.add_argument("--match", default="True", type="bool",
                        help="match modalities at start of training")
    parser.add_argument("--distribution", default="default", type=str,
                        choices=["gauss", "default", "zipf"],
                        help="target cluster-size distribution")

    # #### dist parameters ####
    parser.add_argument("--dist_url", default="env://", type=str,
                        help="unused on TPU (kept for CLI compatibility)")
    parser.add_argument("--world_size", default=-1, type=int,
                        help="set automatically from the JAX runtime")
    parser.add_argument("--rank", default=0, type=int,
                        help="set automatically from the JAX runtime")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="unused (CLI compatibility)")
    parser.add_argument("--bash", action="store_true",
                        help="unused (CLI compatibility)")
    parser.add_argument("--resume", default="False", type="bool",
                        help="resume from checkpoint")

    # #### model parameters ####
    parser.add_argument("--vid_base_arch", default="r2plus1d_18", type=str,
                        choices=["r2plus1d_18"], help="video architecture")
    parser.add_argument("--aud_base_arch", default="resnet9", type=str,
                        choices=["resnet9", "resnet18", "resnet34",
                                 "resnet50"],
                        help="audio architecture")
    parser.add_argument("--use_mlp", type="bool", default="True",
                        help="use MLP head")
    parser.add_argument("--mlp_dim", default=256, type=int,
                        help="number of clusters (head output dim)")
    parser.add_argument("--headcount", default=1, type=int,
                        help="number of heads")

    # #### other parameters ####
    parser.add_argument("--workers", default=10, type=int,
                        help="number of data loading workers")
    parser.add_argument("--checkpoint_freq", type=int, default=5,
                        help="archive checkpoint every N epochs")
    parser.add_argument("--use_fp16", type="bool", default="False",
                        help="compat flag; TPU uses --compute_dtype")
    parser.add_argument("--sync_bn", type=str, default="pytorch",
                        help="compat flag; BN stats are always global on TPU")
    parser.add_argument("--dump_path", type=str, default=".",
                        help="experiment dump path")
    parser.add_argument("--seed", type=int, default=31, help="seed")

    # #### TPU-native extensions ####
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="activation/conv compute dtype on device")
    parser.add_argument("--model_axis", type=int, default=1,
                        help="mesh model-axis size (data axis = n/model)")
    parser.add_argument("--bn_warmup_batches", type=int, default=20,
                        help="BN running-stat warmup batches before epoch 0")
    parser.add_argument("--prefetch", type=int, default=4,
                        help="host->device prefetch depth (4 measured 1.7x "
                             "end-to-end vs 2 on a bandwidth-limited link; "
                             "flat beyond 4 - see BASELINE.md r2)")
    parser.add_argument("--tpu_aligned_midplanes", type="bool",
                        default="False",
                        help="round (2+1)D midplane widths to multiples of "
                             "128 for MXU efficiency (changes param count "
                             "vs. the reference architecture)")
    parser.add_argument("--worker_mode", type=str, default="thread",
                        choices=["thread", "process"],
                        help="loader worker type: threads (default) or "
                             "spawned processes (GIL-free decode)")
    parser.add_argument("--device_spectrogram", type="bool",
                        default="False",
                        help="ship raw PCM to the device and compute "
                             "log-filterbank spectrograms there (rfft + "
                             "mel matmul, ops/logmel.py) instead of on "
                             "the host")
    parser.add_argument("--trace_profile", type="bool", default="False",
                        help="capture a profiler trace of the first "
                             "epoch into {dump_path}/profile/trace.json")
    parser.add_argument("--sk_backend", type=str, default="auto",
                        choices=["auto", "plain", "fused", "xla", "pallas"],
                        help="Sinkhorn solver backend (auto = the fused "
                             "CUDA kernel for CUDA tensors, plain torch on "
                             "the CPU; the JAX names xla and pallas mean "
                             "plain and fused)")
    parser.add_argument("--sk_bf16", type="bool", default="False",
                        help="bf16 storage of the SK matrix (half the "
                             "bytes; the fused iteration 1.3x as fast as "
                             "fp32 at 170752x309 on an NVIDIA H100 80GB "
                             "HBM3, see PERF.md; trades label bit-parity; "
                             "fp32 default)")
    parser.add_argument("--async_checkpoint", type="bool", default="True",
                        help="serialize + write checkpoints on a background "
                             "thread (the step loop continues immediately); "
                             "writes are still atomic and flushed before "
                             "exit/preemption")
    parser.add_argument("--coalesce_transfers", type="bool", default="True",
                        help="pack each batch into one pinned uint8 buffer, "
                             "field after field, for ONE host-to-card copy "
                             "per batch, split on the card into views "
                             "(bit-exact)")
    parser.add_argument("--data_echo", type=int, default=1,
                        help="train this many steps per loaded batch, each "
                             "with fresh on-device augmentations (data "
                             "echoing, arXiv:1907.05550) - raises "
                             "throughput ~xN on input-bound hosts; 1 = "
                             "reference semantics")
    parser.add_argument("--max_host_mem_gb", type=float, default=0,
                        help="host-RSS watchdog: checkpoint and exit "
                             "cleanly (preemption path) when the process "
                             "RSS crosses this many GB, so an outer "
                             "requeue loop resumes instead of an OOM "
                             "kill; 0 disables")
    parser.add_argument("--sk_agg_batch", type=int, default=128,
                        help="per-device batch for the SK feature-"
                             "aggregation forward (eval-mode encode, "
                             "99.8%% of the self-labeling phase). The "
                             "fwd-only encode saturates later than the "
                             "train step: 128 measured +16%% over 64 on "
                             "the v5e (experiments/step_shaping.py)")
    parser.add_argument("--sk_cache_batches", type="bool", default="False",
                        help="cache decoded batches ON DEVICE across the "
                             "ind_groups aggregation passes of each SK "
                             "step (one decode+H2D per step; groups still "
                             "see fresh device augmentations). Needs the "
                             "dataset to fit in HBM")
    parser.add_argument("--strict_probe", type="bool", default="False",
                        help="fail dataset construction when no ffprobe "
                             "binary exists instead of skipping the "
                             "AV-validity filter (the fail-open default "
                             "warns loudly once)")
    parser.add_argument("--sk_augment", type="bool", default="True",
                        help="apply fresh device augmentations (hflip + "
                             "optional colorjitter/grayscale) during SK "
                             "feature aggregation, like the reference's "
                             "fully-augmented aggregation pass "
                             "(sk_utils.py:153-174); false = deterministic "
                             "normalize-only encode")
    return parser
