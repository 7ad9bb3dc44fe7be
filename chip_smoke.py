#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``selavi_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels and its C++ host data runtime from the
checkout's sources (``selavi_tpu_torch/csrc/{fused_sk,conv3x3}.cu`` and
``selavi_tpu_torch/native/data_runtime.cpp`` into
``build/selavi_tpu_torch/``, one ``nvcc`` per source and ``g++``, started
together; it fails if the host runtime does not load), holds each kernel
against its plain PyTorch version on the card, and drives the port's paths
with the launch counts set to 0 just before and read just after each:
- the main path: the pretraining CLI (``selavi_tpu_torch.cli.main``) at the
  full width of the reference VGG-Sound recipe, on a temporary
  ``--dump_path`` outside the checkout, in two runs. Run 1 (BN warmup,
  epoch 0 with one Sinkhorn-Knopp re-clustering, which runs the fused SK
  kernel, and its checkpoint) gets SIGUSR1 early in epoch 1 and must exit
  0 with a checkpoint stamped epoch 1; its checkpoint restores into a
  fresh Trainer bit for bit; run 2, the same command with
  ``--trace_profile true``, resumes at epoch 1 with no warmup and no SK
  step, trains it under the profiler and writes its checkpoint. The
  checkpoint's save, write and restore times and size, the traced
  epoch's device time by operation, and the SK step's modality matcher
  (its route, which must be the native one, and seconds for the 10
  heads, beside the Python loop's on the same cost matrices) are printed;
- the eval path on run 2's checkpoint: ``selavi_tpu_torch.cli.
  get_clusters`` at the recipe's widths (480 samples, fp32, batch 64, 8
  loader threads) writes the cluster dump, whose schema and finite values
  are checked and whose first 16 samples' logits are held against the
  port's CPU result; ``selavi_tpu_torch.cli.clustering_metrics`` reports
  on it. The dump's seconds, clips/s and peak memory are printed;
- the rest of the evaluation suite on run 2's checkpoint, which launches
  no hand kernel (the counts must stay at 0): the checkpoint exported to
  the reference ``.pth`` layout (``train/torch_export.py``) and imported
  back (``train/torch_import.py``) bit for bit, and
  ``selavi_tpu_torch.cli.get_clusters`` on the ``.pth`` giving the
  checkpoint's dump; ``selavi_tpu_torch.cli.cluster_vis`` (its cluster
  count); on a UCF-layout tree from ``scripts/make_real_media.py --layout
  ucf`` (cv2 mp4s and WAV sidecars made on the machine, 128 px frames),
  ``selavi_tpu_torch.cli.video_retrieval`` at the reference recipe (32
  frames at 112 px, batch 32, max pool): v-v, a-v into the feature cache
  and a-v again from it, with the features' seconds, clips/s, peak memory
  and Recall@k, and the share of the card's kNN lists equal to an fp64
  CPU solve; the finetune train step (batch 32 of 32x128x128, bf16) and
  eval step on a resident batch from run 2's tower, then
  ``selavi_tpu_torch.cli.finetune_video --dataset ucf101`` on fold 1, one
  epoch, and again with ``--epochs 2 --resume true``, which must start at
  epoch 1;
- the loader modes: the same CLI recipe for one epoch with spawned loader
  workers, data echo 2 and coalesced transfers (``--worker_mode process
  --data_echo 2 --coalesce_transfers true``): twice the steps of the
  loaded batches, one SK step with matching, the workers stopped at the
  end; its epoch's clips/s without the SK step;
- dual_data: the same recipe with ``--dual_data true`` on 240 samples (two
  30-frame clips and a 2-channel spectrogram a sample): BN warmup, one SK
  step, an epoch; then the step on a resident batch and its peak memory;
- the packed path: a shard of the same recipe written by ``python -m
  selavi_tpu_torch.cli.pack_dataset`` (480 synthetic samples, 30 frames
  stored at 160x160 in YUV 4:2:0, 48000 int16 PCM samples each), then the
  CLI on it (``--ds_name packed --train_crop_size 112``, one epoch with BN
  warmup and one SK step, which runs the fused SK kernel): the loader
  reads the shard by mmap and crops it, the card turns the YUV planes into
  RGB and the PCM into 257x99 spectrograms (``train/step.py::
  prepare_audio``). A fresh Trainer restored from its checkpoint times the
  step on a resident wire-format batch and an epoch, and the same CLI
  resumed with ``--trace_profile true`` traces one epoch with the host
  ops' input shapes, which name the layers behind the fp32 FFMA
  convolution kernels;
- the SK cache: the recipe with ``--ind_groups 2``, one SK step without
  and one with ``--sk_cache_batches`` (two aggregation loaders against
  one), each with its seconds, split and peak memory;
- resnet50: a Trainer at the recipe with ``--aud_base_arch resnet50``
  takes 3 steps, times the step on a resident batch and runs one SK step
  on its 2048-d audio features;
- the conv probe: ``selavi_tpu_torch.experiments.conv3x3``'s ``check()``
  and ``bench()``, which run the conv3x3 forward, dgrad and wgrad kernels
  and time them beside cuDNN at R(2+1)D layer1's shape (all three bf16
  kernels there on their wgmma routes; the per-route counts show it).
Before the packed path it holds the card's audio frontend against the
host's numpy spectrogram (a batch of 24 clips of 48000 samples, 257
filters, z-normalized) and the card's YUV decode against its CPU result
at ``[24, 30, 112, 112]``, and prints which real-media decoders the
machine has (the real-media path itself is held against the JAX package
by the CPU tests).
Then it times the SK kernel and the train step, and the synthetic epoch
with the host's native data runtime on threads, then with its numpy twins,
then twice native on spawned worker processes. For
the SK kernel it also
holds the library's tiling (``sk_plan``) against ``plan()`` at every shape
it compares, checks that an M off a 16-byte boundary is refused and that
the solver and the main path launch the kernel once an iteration, and
prints the kernel's registers and spills, its grid, the host's time to
enqueue an iteration and the solver's it/s at paper scale in fp32 and
bf16. Every SK step prints its split (aggregation, matching, the solves;
``selflabel/engine.py::timings``) beside its ``sk_time``. Every phase
raises on failure, so any failure exits non-zero. Standard output ends with a line
``{"kernels": [...]}`` and then the result line ``{"ok": true, "device":
{...}}``; logs go to standard error.

Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import signal
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# Main path: the reference VGG-Sound recipe at full width (R(2+1)D-18 with
# parity midplanes, ResNet-9 audio, 10 heads, K=309, 30x112x112 video,
# 257x99 spectrograms, batch 24, bf16), through the CLI with --epochs 2.
# Cut to size: 480 synthetic samples (epochs of 20 steps), one SK step at
# iteration 0, 2 BN-warmup batches.
MAIN_ARGS = (
    "--ds_name synthetic --num_data_samples 480 --batch_size 24 "
    "--headcount 10 --mlp_dim 309 --num_frames 30 --train_crop_size 112 "
    "--aud_spec_type 2 --aud_sample_rate 48000 --epochs 1 --nopts 1 "
    "--match true --compute_dtype bfloat16 --bn_warmup_batches 2 "
    "--workers 8 --base_lr 0.01 --wd 0.00001 --seed 31"
)
PREEMPT_STEP = 2  # run 1 gets SIGUSR1 after this many steps of epoch 1
# The loader modes on the main path's recipe: spawned workers (the
# recipe's 8), each loaded batch trained twice, one copy to the card a batch.
LOADER_MODE_ARGS = ("--worker_mode process --data_echo 2 "
                    "--coalesce_transfers true")
# --dual_data on the main path's recipe (two 30-frame clips and two audio
# channels a sample, batch 24), cut to 240 samples (epochs of 10 steps).
DUAL_SAMPLES = 240
# The packed path: the same recipe from a shard that stores the video at
# the top of train_scale_range(112) in YUV 4:2:0 and the audio as int16 PCM.
PACK_ARGS = ("--train_crop_size 160 --pack_video_format yuv420 "
             "--pack_pcm_dtype int16")
PACK_SHAPE = [30, 160, 160, 3]
PCM_SAMPLES = 48000  # one second at 48 kHz
# The eval path: root get_clusters.py's defaults (fp32, batch 64, 8 loader
# threads) on the main path's dataset, widths and spectrograms.
EVAL_ARGS = (
    "--ds_name synthetic --num_data_samples 480 --headcount 10 "
    "--mlp_dim 309 --num_frames 30 --train_crop_size 112 --aud_spec_type 2 "
    "--aud_sample_rate 48000 --z_normalize false --seed 31 --batch_size 64 "
    "--workers 8"
)
EVAL_CPU_SAMPLES = 16  # recomputed by the port on the CPU
# The rest of the evaluation suite on run 2's checkpoint. A UCF-layout tree
# from scripts/make_real_media.py (cv2 mp4s with WAV sidecars, 128 px
# frames, 2 s at 30 fps, 48 kHz audio, 3 official-format folds), cut to 48
# videos of 6 classes: fold 1 has 30 train and 18 test videos.
UCF_MEDIA_ARGS = ("--layout ucf --num_videos 48 --num_classes 6 "
                  "--frame_size 128 --duration 2.0 --aud_sample_rate 48000")
# Retrieval at the reference recipe (root video_retrieval.py's defaults:
# 32 frames at 112 px, 10 clips a video, batch 32, max pool) with run 2's
# heads.
RETRIEVAL_ARGS = ("--dataset ucf101 --fold 1 --clip_len 32 --batch_size 32 "
                  "--pool_op max --workers 8 --headcount 10 "
                  "--num_clusters 309")
# The card's neighbour lists against an fp64 CPU solve on the same
# features: both solve in fp64, so only a tie closer than fp64's rounding
# could order two neighbours differently.
KNN_MIN_SHARE = 0.99
# Finetuning at the reference recipe (root finetune_video.py's defaults:
# 32 frames, crop 128 with --augtype 1, batch 32, bf16): the step on a
# resident batch, FT_REPS times, then the CLI on fold 1 of the tree, one
# epoch, then a second resumed.
FT_BATCH = (32, 32, 128, 128, 3)
FT_REPS = 10
FT_ARGS = ("--dataset ucf101 --fold 1 --clip_len 32 --batch_size 32 "
           "--workers 8")
# get_clusters on the exported .pth against the checkpoint: the eval
# path's recipe cut to 96 samples. The same weights bit for bit, but two
# runs may take cuDNN kernels that sum in another order: of max |logit|.
PTH_SAMPLES = 96
PTH_DUMP_RTOL = 1e-5
# cluster_vis: the main path's dataset flags (480 samples, K = 309).
CLUSTER_VIS_ARGS = (
    "--ds_name synthetic --num_data_samples 480 --mlp_dim 309 "
    "--num_frames 30 --train_crop_size 112 --aud_spec_type 2 "
    "--aud_sample_rate 48000 --z_normalize false --seed 31")
# The card's fp32 logits (cuDNN, TF32 off) against the CPU's on the same
# samples and weights: the same products summed in another order through
# 18 layers; of max |logit| over the heads.
EVAL_RTOL = 1e-3
# The card's frontend against the host's numpy float64 spectrogram, of the
# z-normalized values (JAX's own test of its frontend uses the same).
FRONTEND_RTOL = FRONTEND_ATOL = 2e-3
FRONTEND_CFG = {"samplerate": 48000, "nfilt": 257, "z_normalize": True}
PAPER_N, PAPER_K = 170752, 309  # VGG-Sound SK scale
# Kernel vs plain: the main path's N=480, the paper scale, and the edges of
# the kernel's tiling (32-row tiles bulk-copied by the 16 bytes): an
# unaligned K (37) with a tail whose bytes are no multiple of 16 (301 rows,
# 13 in the last tile), one row, less than one tile (7 rows), K = 1 (one
# live lane) and K = 512 (the widest, 16 columns a lane, 3 ring stages in
# fp32).
SK_SHAPES = ((300, 37), (480, 309), (1, PAPER_K), (7, PAPER_K), (301, 37),
             (480, 1), (480, 512), (PAPER_N, PAPER_K))
HOST_REPS = 200  # iterations enqueued to time the host's part of one
# Kernel vs plain: same fp32 arithmetic, sums in another order (per-warp
# online LSE merged across blocks vs torch's reductions).
VEC_RTOL = 1e-5  # of max |ref|, on log_alpha_next and log_beta_new
ERR_RTOL = 1e-5  # relative, on the error sum
OPS_PER_ELEMENT = 9  # add, max, sub, exp, add (row); add, max, exp, add (col)
# Conv kernels vs plain, of max |ref|. fp32 sums (the fp32 outputs, and the
# fp32 wgrad of bf16 inputs, whose products are exact): the same products
# summed in another order. 1e-5 covers sums of up to 4096 terms; the error
# of a longer sum grows as the square root of its length (the wgrad sums
# N*H*W terms, 1.5M at the bench shape). A bf16 output may also round to
# the neighbouring bf16 value: one bf16 ulp at the largest value, 2^-7 of
# it.
CONV_FP32_RTOL = 1e-5
CONV_FP32_TERMS = 4096
BF16_ULP = 2.0 ** -7
# Beside the probe's shapes, each with the kernels that take its bf16
# forward, dgrad (the forward's routes at C and Co swapped) and weight
# gradient (the probe's own shapes take wgmma for all three): channel
# counts that no 16-byte load fits (the element-load paths); a shape that
# fills no wgmma tile in any dimension (C = 72, Co = 136, 231 pixels: not a
# multiple of the weight gradient's 64-pixel slice or the forward's
# 128-pixel tile), whose forward and dgrad weights do not fit in shared
# memory; image rows longer than a slice (W = 70); an image of one pixel;
# images smaller than a forward tile (45 pixels: one tile spans all five
# images, and every dy border falls inside it); image rows longer than a
# tile (W = 130); C = 72, a multiple of 8 but not of the forward's 64-channel
# slice (Co = 64: the weights fit); two output-channel blocks of the
# forward (Co = 136), whose dgrad weights do not fit; and C = 3, Co = 5, no
# multiple of 4, so the fp32 kernels copy both operands by 4 bytes.
CONV_RAGGED_SHAPES = {
    (2, 9, 13, 3, 136): ("wmma", "wmma", "wmma"),
    (3, 7, 11, 72, 136): ("wmma", "wmma", "wgmma"),
    (2, 3, 70, 16, 24): ("wgmma", "wgmma", "wgmma"),
    (1, 1, 1, 8, 8): ("wgmma", "wgmma", "wgmma"),
    (5, 3, 3, 64, 128): ("wgmma", "wgmma", "wgmma"),
    (2, 3, 130, 64, 128): ("wgmma", "wgmma", "wgmma"),
    (2, 5, 7, 72, 64): ("wgmma", "wgmma", "wgmma"),
    (1, 6, 10, 16, 136): ("wgmma", "wmma", "wgmma"),
    (1, 5, 7, 3, 5): ("wmma", "wmma", "wmma"),
}
# (name in the kernels line, the TPU kernel it replaces: file:line)
CONV_KERNELS = (
    ("conv3x3", "experiments/pallas_conv3x3.py:94"),
    ("conv3x3_dgrad", "experiments/pallas_conv3x3.py:194"),
    ("conv3x3_wgrad", "experiments/pallas_conv3x3.py:162"),
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sk_instance(torch, n, k, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    lv = torch.randn(n, k, generator=g, device=device) * 2
    la = torch.randn(n, k, generator=g, device=device) * 2
    log_ps = torch.log_softmax(lv, 1) + torch.log_softmax(la, 1)
    log_r = torch.full((k,), -math.log(k), device=device)
    return log_ps, log_r


def numpy_sk_instance(torch, n, k, seed, device):
    """The CPU tests' fixtures (numpy logits, seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lv = torch.from_numpy(rng.standard_normal((n, k)) * 2).float().to(device)
    la = torch.from_numpy(rng.standard_normal((n, k)) * 2).float().to(device)
    log_ps = torch.log_softmax(lv, 1) + torch.log_softmax(la, 1)
    return log_ps, torch.full((k,), -math.log(k), device=device)


def kernel_vs_plain(torch, sf, device, report):
    """Phase 2a: the kernel against its plain version on the card, and the
    library's tiling against ``plan()``."""
    worst = 0.0
    inputs = {}
    sms = sf.sm_count(device.index)
    for n, k in SK_SHAPES:
        log_ps, log_r = sk_instance(torch, n, k, seed=n, device=device)
        m32 = (10.0 * log_ps).contiguous()
        log_beta = torch.full((n,), -math.log(n), device=device)
        log_alpha = log_r - torch.logsumexp(m32 + log_beta[:, None], 0)
        for m in (m32, m32.to(torch.bfloat16)):
            plan = sf.plan(n, k, m.dtype, sms)
            check(sf.library_plan(n, k, m.dtype, sms) == plan,
                  f"the library's plan at {n}x{k} {m.dtype}: "
                  f"{sf.library_plan(n, k, m.dtype, sms)} vs {plan}")
            args = (m, log_alpha, log_beta, log_r)
            a1, b1, e1 = sf.fused_sk_iteration(*args)
            a0, b0, e0 = sf.fused_sk_iteration_plain(*args)
            a2, b2, e2 = sf.fused_sk_iteration(*args)
            torch.cuda.synchronize()
            da = float((a1 - a0).abs().max())
            db = float((b1 - b0).abs().max())
            de = abs(float(e1) - float(e0)) / max(abs(float(e0)), 1e-30)
            scale_a = float(a0.abs().max())
            scale_b = float(b0.abs().max())
            deterministic = (torch.equal(a1, a2) and torch.equal(b1, b2)
                             and torch.equal(e1, e2))
            print(f"kernel vs plain {n}x{k} {str(m.dtype)[6:]}: "
                  f"max|d log_alpha| {da:.3g} (scale {scale_a:.3g}), "
                  f"max|d log_beta| {db:.3g} (scale {scale_b:.3g}), "
                  f"err rel diff {de:.3g}, repeat bit-identical "
                  f"{deterministic}", flush=True)
            check(da <= VEC_RTOL * max(scale_a, 1.0), f"log_alpha {n}x{k}")
            check(db <= VEC_RTOL * max(scale_b, 1.0), f"log_beta {n}x{k}")
            check(de <= ERR_RTOL, f"err {n}x{k}")
            check(deterministic, f"kernel determinism {n}x{k}")
            worst = max(worst, da, db)
            inputs[(n, k, m.dtype)] = args
    # An M that does not start on a 16-byte boundary is refused.
    flat = torch.zeros(1 + 300 * 37, device=device)
    vecs = inputs[(300, 37, torch.float32)][1:]
    try:
        sf.fused_sk_iteration(flat[1:].view(300, 37), *vecs)
        refused = False
    except ValueError:
        refused = True
    print(f"kernel refuses an M at a 4-byte offset: {refused}", flush=True)
    check(refused, "a misaligned M is refused")
    lib = sf._library()
    for dtype in (torch.float32, torch.bfloat16):
        p = sf.plan(PAPER_N, PAPER_K, dtype, sms)
        info = sf.kernel_info(PAPER_K, dtype)
        print(f"fused SK kernel at K={PAPER_K} {str(dtype)[6:]}: "
              f"{info['registers']} registers, {info['local_bytes']} bytes "
              f"of local memory (spills), grid {p.grid} of {sms} SMs, "
              f"{p.stages} stages of {p.stage_bytes} bytes, "
              f"{p.smem_bytes} bytes of shared memory, "
              f"{lib.sk_launches_per_iteration()} launch(es) per iteration",
              flush=True)
        report[f"sk_info_{str(dtype)[6:]}"] = info
    report["max_abs_err"] = worst
    return inputs


def solver_fused_vs_plain(torch, sf, device, report):
    """Phase 2b: the SK solver on the fused backend against plain, on CUDA."""
    from selavi_tpu_torch.selflabel.sinkhorn import sinkhorn_knopp

    for n, k, seed in ((257, 12, 1), (300, 37, 0), (300, 10, 2)):
        log_ps, log_r = numpy_sk_instance(torch, n, k, seed, device)
        fused = sinkhorn_knopp(log_ps, log_r, backend="fused")
        plain = sinkhorn_knopp(log_ps, log_r, backend="plain")
        same = bool(torch.equal(fused.labels, plain.labels))
        print(f"solver {n}x{k}: fused iters {fused.iters}, plain iters "
              f"{plain.iters}, labels identical {same}", flush=True)
        check(same and fused.iters == plain.iters, f"solver {n}x{k}")

    log_ps, log_r = sk_instance(torch, PAPER_N, PAPER_K, seed=7,
                                device=device)
    sinkhorn_knopp(log_ps[:480], log_r, backend="fused")  # warm-up
    torch.cuda.synchronize()
    sf.reset_launches()
    t0 = time.perf_counter()
    fused = sinkhorn_knopp(log_ps, log_r, backend="fused")
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    check(sf.launches == fused.iters, "one kernel launch per iteration")
    t0 = time.perf_counter()
    plain = sinkhorn_knopp(log_ps, log_r, backend="plain")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    agree = float((fused.labels == plain.labels).float().mean())
    print(f"solver {PAPER_N}x{PAPER_K} fp32: fused {fused.iters} iters in "
          f"{t_fused:.3f} s ({fused.iters / t_fused:.1f} it/s), plain "
          f"{plain.iters} iters in {t_plain:.3f} s "
          f"({plain.iters / t_plain:.1f} it/s), label agreement {agree:.6f}",
          flush=True)
    check(agree >= 0.999, "paper-scale label agreement >= 99.9%")
    check(abs(fused.iters - plain.iters) <= 10, "paper-scale iters within 10")
    report["solver_it_per_s"] = fused.iters / t_fused
    t0 = time.perf_counter()
    fused16 = sinkhorn_knopp(log_ps, log_r, backend="fused", m_bf16=True)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    report["solver_it_per_s_bf16"] = fused16.iters / t_bf16
    print(f"solver {PAPER_N}x{PAPER_K} bf16: fused {fused16.iters} iters in "
          f"{t_bf16:.3f} s ({fused16.iters / t_bf16:.1f} it/s)", flush=True)


@contextlib.contextmanager
def numpy_host():
    """Run the host's data runtime on its numpy twins (the C++ library
    reported unavailable) inside the block."""
    from selavi_tpu_torch import native

    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


@contextlib.contextmanager
def record_matcher(rec):
    """Time the modality matcher inside the block: each head's cost matrix
    (kept in ``rec["costs"]``), the swap search by its route (``native``:
    the C++ library, ``python``: the loop) and ``match_order`` as a
    whole."""
    from selavi_tpu_torch import native
    from selavi_tpu_torch.selflabel import engine, matching

    rec.update(costs=[], native_s=0.0, python_s=0.0, total_s=0.0)
    wrapped = {}

    def timed(owner, name, key):
        inner = getattr(owner, name)
        wrapped[(owner, name)] = inner

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if key == "costs":
                rec["costs"].append(out.cpu().numpy())
            else:
                rec[key] += time.perf_counter() - t0
            return out

        setattr(owner, name, call)

    timed(matching, "column_cost_matrix", "costs")
    timed(native, "greedy_swap_match_native", "native_s")
    timed(matching, "greedy_swap_match", "python_s")
    timed(engine, "match_order", "total_s")
    try:
        yield rec
    finally:
        for (owner, name), inner in wrapped.items():
            setattr(owner, name, inner)


def _run_cli(cli_main, argv, trainer_cls):
    """``python -m selavi_tpu_torch.cli.main <argv>`` in this process, with
    the CLI's Trainer replaced by ``trainer_cls``; returns the SystemExit
    code (None when it returned) and the Trainer it built."""
    from selavi_tpu_torch.train.loop import Trainer

    built = []

    class Recorded(trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    cli_main.Trainer = Recorded
    code = None
    try:
        cli_main.main(argv)
    except SystemExit as e:
        code = e.code
    finally:
        cli_main.Trainer = Trainer
    return code, built.pop()


def cli_path(torch, sf, device, report, dump):
    """Phase 3: the pretraining CLI at full width, on ``dump``. Run 1 is
    preempted by SIGUSR1 in epoch 1; the restore check loads its
    checkpoint into a fresh Trainer; run 2 resumes and traces epoch 1. The
    SK kernel's count must move in run 1 and stay at 0 in run 2. Returns
    the fresh Trainer."""
    import pickle

    import numpy as np

    from selavi_tpu_torch.cli import main as cli_main
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.train import checkpoint as ckpt
    from selavi_tpu_torch.train import loop
    from selavi_tpu_torch.utils import profiling

    argv = MAIN_ARGS.split() + ["--epochs", "2", "--dump_path", dump]
    args = parse_arguments().parse_args(argv)
    path = os.path.join(dump, ckpt.CKPT_NAME)

    class Preempted(loop.Trainer):
        """SIGUSR1 right after train step PREEMPT_STEP of epoch 1."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner, calls = self.train_step, []

            def train_step(*a):
                out = inner(*a)
                calls.append(1)
                if len(calls) == self.batches_per_epoch + PREEMPT_STEP:
                    os.kill(os.getpid(), signal.SIGUSR1)
                return out

            self.train_step = train_step

    sf.reset_launches()
    ckpt.reset_timings()
    matcher: dict = {}
    t0 = time.perf_counter()
    with record_matcher(matcher):
        code, trainer = _run_cli(cli_main, argv, Preempted)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sf.launches
    report["launches"] = launches
    saves = list(ckpt.timings)
    history, labels = trainer.history, trainer.sl_state.selflabels
    del trainer
    saved = torch.load(path, map_location="cpu", weights_only=True)
    sk = [h for h in history if "sk_cost" in h]
    losses = [h["loss"] for h in history if "iter" in h]
    final = [h["loss"] for h in history if "iter" not in h and "loss" in h]
    print(f"CLI run 1: {wall:.1f} s, SystemExit({code}) after step "
          f"{PREEMPT_STEP} of epoch 1, SK steps {len(sk)}, first loss "
          f"{losses[0]:.4f} (ln {args.mlp_dim} = {math.log(args.mlp_dim):.4f}), "
          f"epoch 0 "
          f"loss {final[0]:.4f}, SK {sk[0] if sk else None}, fused SK "
          f"launches {launches}; checkpoint epoch {saved['epoch']}, step "
          f"{saved['step']}, archive {sorted(os.listdir(os.path.join(dump, 'checkpoints')))}",
          flush=True)
    check(code == 0, "run 1 exits 0 on SIGUSR1")
    check(len(sk) == 1, "one SK step")
    check(math.isfinite(sk[0]["sk_cost"]), "SK cost finite")
    check(sk[0]["sk_iters_max"] < 2000, "SK iters < 2000")
    check(all(math.isfinite(x) for x in losses + final), "losses finite")
    check(abs(losses[0] - math.log(args.mlp_dim)) < 0.5, "first loss ~ ln K")
    check(labels.shape == (args.num_data_samples, args.headcount),
          "label shape")
    check(all(len(set(labels[:, h].tolist())) > 1
              for h in range(args.headcount)), "every head uses >1 cluster")
    check(launches > 0, "the CLI path launched the fused SK kernel")
    check(launches == sk[0]["sk_iters_total"],
          f"one fused SK launch per solver iteration: {launches} launches, "
          f"{sk[0]['sk_iters_total']} iterations")
    check(saved["epoch"] == 1, "run 1's checkpoint resumes at epoch 1")
    check(os.path.isfile(os.path.join(dump, "checkpoints", "ckp-0.pth")),
          "run 1 archived epoch 0")
    nbytes = os.path.getsize(path)
    sk_split_line("CLI run 1", sk[0], report)
    matcher_line(matcher, args.headcount, report)
    for name, rec in zip(("epoch 0", "preemption"), saves):
        print(f"save_checkpoint ({name}) on {report['card']}: held the step "
              f"loop {rec['hold_s']:.3f} s, async write {rec['write_s']:.3f} "
              f"s, {rec['bytes']} bytes", flush=True)
    report["ckpt_saves"] = saves

    # The restore check: a fresh Trainer on the card, bit for bit.
    fresh = loop.Trainer(args, build_dataset(args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = fresh.resume()  # restore_checkpoint, then the SK schedule
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state = fresh.model.state_dict()
    same_model = set(state) == set(saved["model"]) and all(
        state[k].device == device and torch.equal(state[k].cpu(), v)
        for k, v in saved["model"].items())
    opt = fresh.optimizer.state_dict()
    same_opt = (opt["param_groups"] == saved["optimizer"]["param_groups"]
                and set(opt["state"]) == set(saved["optimizer"]["state"])
                and all(opt["state"][i]["momentum_buffer"].device == device
                        and torch.equal(opt["state"][i]["momentum_buffer"].cpu(),
                                        s["momentum_buffer"])
                        for i, s in saved["optimizer"]["state"].items()))
    dists = saved["dist"]["dists"]
    same_host = (
        start == 1 and fresh.step == saved["step"]
        and len(fresh.sk_schedule) == 1  # the sentinel: no SK step left
        and fresh.sl_state.sk_counter == saved["sk_counter"]
        and fresh.sl_state.selflabels.dtype == np.int32
        and np.array_equal(fresh.sl_state.selflabels,
                           saved["selflabels"].numpy())
        and (dists is None) == (fresh.sl_state.marginals.dists is None)
        and (dists is None or np.array_equal(fresh.sl_state.marginals.dists,
                                             dists.numpy())))
    print(f"restore_checkpoint (Trainer.resume) on {report['card']}: "
          f"{restore_s:.3f} s for "
          f"{nbytes} bytes; model tensors bit-identical {same_model} "
          f"({len(state)}), optimizer bit-identical {same_opt} "
          f"({len(opt['state'])} momentum buffers), selflabels / dists / "
          f"sk_counter / step equal {same_host}", flush=True)
    check(same_model, "restored model tensors equal the file")
    check(same_opt, "restored optimizer tensors equal the file")
    check(same_host, "restored host state equals the file")
    report["restore_s"] = restore_s
    report["ckpt_bytes"] = nbytes

    # Run 2: the same command, resumed and traced.
    warmups = []
    traces = []

    class Resumed(loop.Trainer):
        def warmup_batchnorm(self, batches=None):
            warmups.append(1)
            super().warmup_batchnorm(batches)

    @contextlib.contextmanager
    def keep_trace(dump_path, enabled=True):
        with profiling.trace_window(dump_path, enabled) as prof:
            yield prof
        if prof is not None:
            traces.append(prof)

    sf.reset_launches()
    ckpt.reset_timings()
    loop.trace_window = keep_trace
    try:
        t0 = time.perf_counter()
        code, trainer = _run_cli(cli_main, argv + ["--trace_profile", "true"],
                                 Resumed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        loop.trace_window = profiling.trace_window
    history = trainer.history
    del trainer
    saved2 = torch.load(path, map_location="cpu", weights_only=True)
    with open(os.path.join(dump, "stats0.pkl"), "rb") as f:
        stats = pickle.load(f)
    epochs = [h["epoch"] for h in history if "iter" not in h]
    run2_losses = [h["loss"] for h in history if "loss" in h]
    print(f"CLI run 2 (--trace_profile true): {wall:.1f} s, exit {code}, "
          f"epochs trained {epochs}, BN warmups {len(warmups)}, SK steps "
          f"{sum('sk_cost' in h for h in history)}, fused SK launches "
          f"{sf.launches}, epoch 1 loss {run2_losses[-1]:.4f}; checkpoint "
          f"epoch {saved2['epoch']}, archive "
          f"{sorted(os.listdir(os.path.join(dump, 'checkpoints')))}, stats "
          f"rows {stats['rows']}", flush=True)
    check(code is None, "run 2 returns")
    check(epochs == [1], "run 2 starts at epoch 1 and trains it")
    check(not warmups, "no BN warmup on resume")
    check(not any("sk_cost" in h for h in history), "no SK step on resume")
    check(sf.launches == 0, "no fused SK launch on resume")
    check(all(math.isfinite(x) for x in run2_losses), "run 2 losses finite")
    check(saved2["epoch"] == 2, "run 2's checkpoint resumes at epoch 2")
    check(os.path.isfile(os.path.join(dump, "checkpoints", "ckp-1.pth")),
          "run 2 archived epoch 1")
    check(len(stats["rows"]) == 1 and stats["rows"][0][0] == 1,
          "one stats row, epoch 1")
    rec = ckpt.timings[0]
    print(f"save_checkpoint (epoch 1) on {report['card']}: held the step "
          f"loop {rec['hold_s']:.3f} s, async write {rec['write_s']:.3f} s, "
          f"{rec['bytes']} bytes", flush=True)
    trace_split(torch, os.path.join(dump, "profile", profiling.TRACE_NAME),
                traces, report)
    return fresh


def matcher_line(rec, heads, report):
    """Print the SK step's matcher: its route and seconds for the heads,
    and the Python loop's seconds on the same cost matrices."""
    import numpy as np

    from selavi_tpu_torch import native
    from selavi_tpu_torch.selflabel import matching

    route = "native" if rec["native_s"] > 0 and rec["python_s"] == 0 \
        else "python"
    t0 = time.perf_counter()
    for cost in rec["costs"]:
        matching.greedy_swap_match(cost, rng=np.random.default_rng(0))
    loop_s = time.perf_counter() - t0
    print(f"matcher in the SK step on {report['card']}'s host: "
          f"{len(rec['costs'])} heads at K={rec['costs'][0].shape[0]}, "
          f"route {route}, search {rec[route + '_s']:.4f} s, match_order "
          f"{rec['total_s']:.4f} s (cost matrices included); the Python "
          f"loop on the same {len(rec['costs'])} cost matrices "
          f"{loop_s:.3f} s", flush=True)
    check(len(rec["costs"]) == heads, f"{heads} heads matched")
    check(route == "native" and native.available(),
          "the SK step matched on the native route")
    report["matcher"] = {"route": route, "search_s": rec[route + "_s"],
                         "total_s": rec["total_s"], "python_loop_s": loop_s}


def sk_split_line(label, sk, report):
    """Print the last SK step's split (``selflabel/engine.py::timings``)
    beside its ``sk_time``; the spans must fit inside it."""
    from selavi_tpu_torch.selflabel import engine

    t = dict(engine.timings)
    spans = t["aggregate_s"] + t["match_s"] + t["solve_s"]
    print(f"SK split ({label}) on {report['card']}: sk_time "
          f"{sk['sk_time']:.4f} s = aggregation {t['aggregate_s']:.4f} s + "
          f"matching {t['match_s']:.4f} s + solves {t['solve_s']:.4f} s "
          f"({sk['sk_iters_total']} iterations) + the rest "
          f"{sk['sk_time'] - spans:.4f} s", flush=True)
    check(set(t) == {"aggregate_s", "match_s", "solve_s"}
          and spans <= sk["sk_time"],
          f"the SK split {t} fits inside sk_time {sk['sk_time']}")
    report.setdefault("sk_split", {})[label] = dict(t, sk_time=sk["sk_time"])


def eval_path(torch, device, report, dump):
    """Phase 3a: the cluster-quality evaluation of run 2's checkpoint at
    full width: ``cli.get_clusters`` (fp32) writes the dump, whose schema,
    labels and finite values are checked and whose first EVAL_CPU_SAMPLES
    samples the port recomputes on the CPU; ``cli.clustering_metrics``
    reports on it."""
    import pickle

    import numpy as np

    from selavi_tpu_torch.cli import clustering_metrics, get_clusters
    from selavi_tpu_torch.data.factory import (
        audio_cfg_from_args,
        build_dataset,
    )
    from selavi_tpu_torch.data.loader import DataLoader
    from selavi_tpu_torch.models.av_model import load_model
    from selavi_tpu_torch.train import step as steps
    from selavi_tpu_torch.train.checkpoint import (
        CKPT_NAME,
        load_model_parameters,
    )

    weights = os.path.join(dump, CKPT_NAME)
    out = os.path.join(dump, "ps_matrices.pkl")
    argv = EVAL_ARGS.split() + ["--weights_path", weights, "--output_path",
                                out]
    args = get_clusters.parse_args(argv)
    n, h, k = args.num_data_samples, args.headcount, args.mlp_dim
    timed = {}
    inner = get_clusters.dump_cluster_matrices

    def timed_dump(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*a, **kw)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t0
        return res

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    get_clusters.dump_cluster_matrices = timed_dump
    try:
        t0 = time.perf_counter()
        ps_v, labels, ps_a = get_clusters.main(argv)
        wall = time.perf_counter() - t0
    finally:
        get_clusters.dump_cluster_matrices = inner
    peak = torch.cuda.max_memory_allocated() / 1e9
    with open(out, "rb") as f:
        payload = pickle.load(f)
    schema = (
        len(payload) == 3 and len(payload[0]) == len(payload[2]) == h
        and all(isinstance(m, torch.Tensor) and m.dtype == torch.float32
                and tuple(m.shape) == (n, k) and bool(torch.isfinite(m).all())
                for m in payload[0] + payload[2])
        and payload[1].dtype == torch.int64
        and tuple(payload[1].shape) == (n,))
    dataset = build_dataset(args, eval_mode=True)
    dump_s = timed["s"]
    print(f"get_clusters CLI on run 2's checkpoint ({n} samples, fp32, batch "
          f"{args.batch_size}, {args.workers} loader threads) on "
          f"{report['card']}: dump {dump_s:.2f} s, {n / dump_s:.2f} clips/s; "
          f"CLI {wall:.2f} s (model and checkpoint load included); peak "
          f"memory {peak:.2f} GB ({resident:.2f} GB resident before); pickle "
          f"{os.path.getsize(out)} bytes, {h} float32 [{n}, {k}] tensors a "
          f"side and int64 labels [{n}]: {schema}", flush=True)
    check(schema, "the dump's schema, dtypes, shapes and finite values")
    check(np.array_equal(labels, dataset.labels), "the dump's labels")

    # The first samples again, on the CPU in fp32 from the same file.
    cpu_model = load_model(aud_base_arch=args.aud_base_arch,
                           use_mlp=args.use_mlp, headcount=h, num_classes=k,
                           device="cpu")
    load_model_parameters(cpu_model, weights)
    batch = next(iter(DataLoader(dataset, batch_size=EVAL_CPU_SAMPLES,
                                 shuffle=False, drop_last=False,
                                 device="cpu")))
    t0 = time.perf_counter()
    feat_v, feat_a = steps.encode(cpu_model, batch["video"], batch["audio"],
                                  augment=False,
                                  audio_cfg=audio_cfg_from_args(args))
    ref_v = steps.head_logits(cpu_model, feat_v, "v").numpy()
    ref_a = steps.head_logits(cpu_model, feat_a, "a").numpy()
    cpu_s = time.perf_counter() - t0
    rows = batch["index"].numpy()
    err = max(float(np.abs(ps_v[:, rows] - ref_v).max() / np.abs(ref_v).max()),
              float(np.abs(ps_a[:, rows] - ref_a).max() / np.abs(ref_a).max()))
    print(f"dump vs the port on the CPU (first {EVAL_CPU_SAMPLES} samples, "
          f"fp32, {cpu_s:.1f} s there): max |card - cpu| / max |cpu| "
          f"{err:.3g} (tolerance {EVAL_RTOL})", flush=True)
    check(err <= EVAL_RTOL, "the card's dump agrees with the CPU's")
    del cpu_model

    t0 = time.perf_counter()
    metrics = clustering_metrics.main(["--path", out, "--ncentroids", str(k)])
    metrics_s = time.perf_counter() - t0
    print(f"clustering_metrics CLI on the dump ({metrics_s:.2f} s on the "
          f"host): {json.dumps(metrics)}", flush=True)
    check(list(metrics) == ["nmi", "anmi", "ari", "entropy", "purity",
                            "accuracy"]
          and all(math.isfinite(v) for v in metrics.values()),
          "six finite metrics")
    report["eval"] = {"dump_s": dump_s, "clips_per_s": n / dump_s,
                      "peak_mem_gb": peak, "cpu_rel_err": err,
                      "metrics": metrics}


def pth_import_path(torch, device, report, dump, tmp):
    """Phase 3g: run 2's checkpoint exported to the reference .pth layout
    (``train/torch_export.py``) and imported back
    (``train/torch_import.py``): the state_dict bit for bit; then
    ``cli.get_clusters`` on the .pth and on the checkpoint give the same
    dump."""
    import numpy as np

    from selavi_tpu_torch.cli import get_clusters
    from selavi_tpu_torch.models.av_model import load_model
    from selavi_tpu_torch.train import torch_export, torch_import
    from selavi_tpu_torch.train.checkpoint import CKPT_NAME

    weights = os.path.join(dump, CKPT_NAME)
    pth = os.path.join(tmp, "reference.pth.tar")
    t0 = time.perf_counter()
    torch_export.main([weights, pth])
    export_s = time.perf_counter() - t0
    saved = torch.load(weights, map_location="cpu", weights_only=True)["model"]
    model = load_model(headcount=10, num_classes=309, seed=1, device="cpu")
    t0 = time.perf_counter()
    torch_import.import_reference_checkpoint(model, pth)
    import_s = time.perf_counter() - t0
    state = model.state_dict()
    exact = set(state) == set(saved) and all(
        torch.equal(state[k], saved[k]) for k in saved)
    del model, state
    print(f".pth import: run 2's checkpoint exported in {export_s:.2f} s "
          f"({os.path.getsize(pth)} bytes), imported in {import_s:.2f} s; "
          f"state_dict bit-identical {exact} ({len(saved)} tensors)",
          flush=True)
    check(exact, "the imported state_dict equals the checkpoint's")

    argv = EVAL_ARGS.replace("--num_data_samples 480",
                             f"--num_data_samples {PTH_SAMPLES}").split()
    dumps = []
    for path in (weights, pth):
        dumps.append(get_clusters.main(argv + [
            "--weights_path", path, "--output_path",
            os.path.join(tmp, "ps.pkl")]))
    (ps_v, labels, ps_a), (rps_v, rlabels, rps_a) = dumps
    err = max(float(np.abs(rps_v - ps_v).max() / np.abs(ps_v).max()),
              float(np.abs(rps_a - ps_a).max() / np.abs(ps_a).max()))
    same = (np.array_equal(rps_v, ps_v) and np.array_equal(rps_a, ps_a))
    print(f"get_clusters CLI on the .pth against the checkpoint "
          f"({PTH_SAMPLES} samples, fp32) on {report['card']}: labels equal "
          f"{np.array_equal(labels, rlabels)}, max |pth - ckpt| / max |ckpt| "
          f"{err:.3g} (tolerance {PTH_DUMP_RTOL}), bit-identical {same}",
          flush=True)
    check(np.array_equal(labels, rlabels) and err <= PTH_DUMP_RTOL,
          "get_clusters gives the same dump on the .pth")
    report["pth_import"] = {"export_s": export_s, "import_s": import_s,
                            "dump_rel_err": err}


def cluster_vis_path(report, dump, tmp):
    """Phase 3h: ``cli.cluster_vis`` on run 2's checkpoint over the main
    path's dataset: ``clusters.js`` with every sample in one cluster."""
    from selavi_tpu_torch.cli import cluster_vis
    from selavi_tpu_torch.train.checkpoint import CKPT_NAME

    t0 = time.perf_counter()
    payload = cluster_vis.main(CLUSTER_VIS_ARGS.split() + [
        "--weights_path", os.path.join(dump, CKPT_NAME), "--out_dir", tmp])
    wall = time.perf_counter() - t0
    path = os.path.join(tmp, "clusters.js")
    total = sum(c["size"] for c in payload)
    print(f"cluster_vis CLI on run 2's checkpoint (head 0, host only): "
          f"{len(payload)} clusters, {total} samples, {os.path.getsize(path)} "
          f"bytes in {wall:.2f} s", flush=True)
    check(total == 480 and len(payload) >= 1
          and open(path).read().startswith("var clusters = "),
          "clusters.js holds every sample")
    report["cluster_vis"] = {"clusters": len(payload)}


def make_ucf_tree(tmp):
    """A UCF-layout tree (``scripts/make_real_media.py --layout ucf``)
    under ``tmp``; returns its root."""
    import subprocess

    root = os.path.join(tmp, "ucf")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "make_real_media.py")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, script, "--output", root]
                   + UCF_MEDIA_ARGS.split(), check=True, timeout=600,
                   stdout=subprocess.DEVNULL)
    print(f"UCF-layout tree ({UCF_MEDIA_ARGS}) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return root


def retrieval_path(torch, device, report, dump, ucf, tmp):
    """Phase 3i: ``cli.video_retrieval`` at the reference recipe on the
    UCF tree with run 2's weights: v-v (the pooled truncated tower), a-v
    (512-d GAP features of both towers, written to the feature cache) and
    a-v again from the cache; the card's kNN lists against an fp64 CPU
    solve on the v-v features."""
    import pickle

    import numpy as np

    from selavi_tpu_torch.cli import video_retrieval
    from selavi_tpu_torch.eval.retrieval import nearest_neighbors
    from selavi_tpu_torch.train.checkpoint import CKPT_NAME

    base = RETRIEVAL_ARGS.split() + [
        "--root_dir", os.path.join(ucf, "videos"), "--data_path",
        os.path.join(tmp, "meta"), "--weights_path",
        os.path.join(dump, CKPT_NAME)]
    timed = {}
    inner = video_retrieval.compute_features

    def timed_features(args, dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = inner(args, dev)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t0
        timed["clips"] = sum(len(d) for d in video_retrieval.build_datasets(
            args))
        return feats

    caches = {"v-v": os.path.join(tmp, "vv.pkl"),
              "a-v": os.path.join(tmp, "av.pkl")}
    results = []
    video_retrieval.compute_features = timed_features
    try:
        for task in ("v-v", "a-v", "a-v"):
            timed.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            recalls = video_retrieval.main(base + [
                "--task", task, "--feature_cache", caches[task]])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            if timed:
                line = (f"features {timed['s']:.2f} s for {timed['clips']} "
                        f"clips, {timed['clips'] / timed['s']:.2f} clips/s "
                        f"(fp32), peak memory {peak:.2f} GB")
            else:
                line = "features from the cache"
            print(f"video_retrieval CLI {task} on {report['card']}: {line}; "
                  f"CLI {wall:.2f} s; R@k {json.dumps(recalls)}", flush=True)
            check(all(math.isfinite(v) and 0 <= v <= 100
                      for v in recalls.values()), f"{task}: recalls")
            results.append((task, recalls, dict(timed), peak))
    finally:
        video_retrieval.compute_features = inner
    check(not results[2][2] and results[2][1] == results[1][1],
          "a-v from the feature cache gives the same recalls")

    with open(caches["v-v"], "rb") as f:
        feats = pickle.load(f)
    train, val = feats["train"][0], feats["val"][0]
    k = min(50, len(train))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = nearest_neighbors(train, val, k, device)
    knn_s = time.perf_counter() - t0
    cpu = nearest_neighbors(train, val, k, "cpu")
    share = float((card == cpu).all(axis=1).mean())
    print(f"kNN of the v-v features ({len(val)} queries, {len(train)} train "
          f"videos, {train.shape[1]}-d, k {k}) on {report['card']}: "
          f"{knn_s * 1e3:.2f} ms (fp64, transfers included); neighbour lists "
          f"equal to the fp64 CPU solve: {share:.4f}", flush=True)
    check(share >= KNN_MIN_SHARE, "the card's kNN lists agree with the CPU's")
    report["retrieval"] = {
        task: {"recalls": rec, "feature_s": t.get("s"),
               "clips_per_s": t["clips"] / t["s"] if t else None,
               "peak_mem_gb": peak}
        for task, rec, t, peak in results[:2]}
    report["retrieval"]["knn_share_equal"] = share


def finetune_path(torch, device, report, dump, ucf, tmp):
    """Phase 3j: the finetune train step (bf16) and eval step on a resident
    batch at the reference recipe, from run 2's tower; then
    ``cli.finetune_video --dataset ucf101`` on fold 1 of the tree, one
    epoch, and the same command with ``--epochs 2 --resume true``, which
    must start at epoch 1."""
    from selavi_tpu_torch.cli import finetune_video
    from selavi_tpu_torch.eval import finetune as ft
    from selavi_tpu_torch.eval import finetune_runner
    from selavi_tpu_torch.train.checkpoint import CKPT_NAME

    weights = os.path.join(dump, CKPT_NAME)
    cfg = ft.FinetuneConfig(num_classes=ft.NUM_CLASSES["ucf101"])
    model = ft.FinetuneModel(cfg.num_classes, generator=torch.Generator()
                             .manual_seed(0)).to(device)
    finetune_runner.load_pretrained_tower(model, weights)
    opt = ft.make_finetune_optimizer(cfg, model)
    ft.set_finetune_lr(opt, ft.lr_factor_table(cfg), 0, 1)
    train_step, _, eval_step = ft.make_finetune_steps(model, opt,
                                                      torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(0)
    video = torch.randint(0, 256, FT_BATCH, dtype=torch.uint8, generator=g,
                          device=device)
    labels = torch.randint(0, cfg.num_classes, FT_BATCH[:1], generator=g,
                           device=device)
    for _ in range(2):  # warm up
        train_step(video, labels, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [train_step(video, labels, g)[0] for _ in range(FT_REPS)]
    torch.cuda.synchronize()
    train_s = (time.perf_counter() - t0) / FT_REPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    eval_step(video, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FT_REPS):
        logits, eval_loss = eval_step(video, labels)
    torch.cuda.synchronize()
    eval_s = (time.perf_counter() - t0) / FT_REPS
    losses = [float(x) for x in losses]
    print(f"finetune train step on {report['card']} (batch {FT_BATCH[0]} of "
          f"{FT_BATCH[1]}x{FT_BATCH[2]}x{FT_BATCH[3]}, bf16, run 2's tower): "
          f"{FT_BATCH[0] / train_s:.2f} clips/s ({train_s * 1e3:.1f} ms), "
          f"peak memory {peak:.2f} GB, losses {losses[0]:.4f} .. {losses[-1]:.4f}; "
          f"eval step {FT_BATCH[0] / eval_s:.2f} clips/s "
          f"({eval_s * 1e3:.1f} ms)", flush=True)
    check(all(math.isfinite(x) for x in losses)
          and math.isfinite(float(eval_loss))
          and tuple(logits.shape) == (FT_BATCH[0], cfg.num_classes),
          "finetune: finite losses and logits")
    del model, opt, video

    out = os.path.join(tmp, "finetune")
    argv = FT_ARGS.split() + [
        "--root_dir", os.path.join(ucf, "videos"), "--data_path",
        os.path.join(tmp, "meta"), "--weights_path", weights,
        "--output_dir", out]
    ckpt = os.path.join(out, "checkpoints", "checkpoint_fold1.pth")
    walls, steps = [], []
    try:
        for extra in (["--epochs", "1"], ["--epochs", "2", "--resume",
                                           "true"]):
            t0 = time.perf_counter()
            result = finetune_video.main(argv + extra)
            walls.append(time.perf_counter() - t0)
            saved = torch.load(ckpt, map_location="cpu", weights_only=True)
            steps.append((int(saved["epoch"]), int(saved["step"])))
            check(all(math.isfinite(v) for v in result["acc1"]
                      + result["acc5"]), "finetune CLI: finite accuracies")
    finally:
        _restore_process_state()
    with open(os.path.join(out, "train.log")) as f:
        resumed = "resumed finetune fold 1 at epoch 1" in f.read()
    print(f"finetune CLI (--dataset ucf101 --fold 1) on {report['card']}: "
          f"--epochs 1 {walls[0]:.1f} s, then --epochs 2 --resume true "
          f"{walls[1]:.1f} s; (epoch, step) in the checkpoint {steps}; "
          f"resumed at epoch 1 {resumed}", flush=True)
    check(resumed and steps[0][0] == 1 and steps[1] == (2, 2 * steps[0][1]),
          "the resumed run trains epoch 1 only")
    report["finetune"] = {"train_clips_per_s": FT_BATCH[0] / train_s,
                          "eval_clips_per_s": FT_BATCH[0] / eval_s,
                          "peak_mem_gb": peak, "cli_s": walls}


def sk_cache_path(torch, sf, device, report, tmp):
    """Phase 3e: one SK step of the recipe with ``--ind_groups 2``, without
    and with ``--sk_cache_batches``: two aggregation loaders against one,
    the fused SK kernel launched by both."""
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.train import loop

    for cache in ("false", "true"):
        argv = MAIN_ARGS.split() + ["--ind_groups", "2", "--sk_cache_batches",
                                    cache, "--dump_path", tmp]
        args = parse_arguments().parse_args(argv)
        trainer = loop.Trainer(args, build_dataset(args))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sf.reset_launches()
        ran = trainer.maybe_cluster(0)
        torch.cuda.synchronize()
        launches = sf.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        sk = trainer.history[-1]
        loaders = trainer._eval_iter_count
        del trainer
        label = f"--ind_groups 2 --sk_cache_batches {cache}"
        print(f"SK step ({label}) on {report['card']}: sk_time "
              f"{sk['sk_time']:.4f} s, aggregation loaders {loaders}, fused "
              f"SK launches {launches}, peak memory {peak:.2f} GB",
              flush=True)
        check(ran and math.isfinite(sk["sk_cost"]), f"{label}: an SK step")
        sk_split_line(label, sk, report)
        check(loaders == (1 if cache == "true" else 2),
              f"{label}: {loaders} aggregation loaders")
        check(launches > 0 and launches == sk["sk_iters_total"],
              f"{label}: one fused SK launch per solver iteration")
        report[f"sk_cache_{cache}"] = {"sk_time": sk["sk_time"],
                                       "loaders": loaders,
                                       "peak_mem_gb": peak}

    # The aggregation's two parts, each alone: one pass of the loader, and
    # one encode pass over its batches resident on the card.
    from selavi_tpu_torch.selflabel import engine

    trainer = loop.Trainer(args, build_dataset(args))
    n = len(trainer.dataset)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = list(trainer._make_eval_iter())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.aggregate_features(trainer.sk_encode, iter(batches), n,
                              trainer.sk_cfg.feat_dim, device,
                              feat_dim_a=trainer.sk_cfg.feat_dim_a)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del trainer, batches
    print(f"SK aggregation parts on {report['card']}: one loader pass "
          f"{load_s:.4f} s ({n / load_s:.2f} clips/s), one encode pass over "
          f"its batches resident on the card {encode_s:.4f} s "
          f"({n / encode_s:.2f} clips/s, batch {args.sk_agg_batch}, bf16)",
          flush=True)
    report["sk_aggregation_parts"] = {"load_s": load_s, "encode_s": encode_s}


def resnet50_path(torch, sf, device, report, tmp):
    """Phase 3f: the recipe with the resnet50 audio tower: 3 train steps
    with a finite loss, the step timed on a resident batch, and one SK step
    on 2048-d audio features."""
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.data.loader import decode_wire_batch
    from selavi_tpu_torch.train import loop

    argv = MAIN_ARGS.split() + ["--aud_base_arch", "resnet50", "--dump_path",
                                tmp]
    args = parse_arguments().parse_args(argv)
    trainer = loop.Trainer(args, build_dataset(args))
    check(trainer.model.audio_network.feature_dim == 2048
          and trainer.sk_cfg.feat_dim_a == 2048, "resnet50: 2048-d features")
    batch = decode_wire_batch(next(iter(trainer.loader)))
    labels = torch.zeros(batch["index"].shape[0], args.headcount,
                         dtype=torch.long, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    losses = [float(trainer.train_step(batch, labels, gen)["loss"])
              for _ in range(3)]
    check(all(math.isfinite(x) for x in losses), "resnet50: finite losses")
    time_train(torch, trainer, report, prefix="r50_", epoch=False)
    print(f"resnet50 audio tower train on {report['card']}: losses "
          f"{[round(x, 4) for x in losses]}, "
          f"{report['r50_train_clips_per_s']:.2f} clips/s (train step on a "
          f"resident batch of 24, bf16), peak memory "
          f"{report['r50_peak_mem_gb']:.2f} GB in the step", flush=True)
    sf.reset_launches()
    ran = trainer.maybe_cluster(0)
    torch.cuda.synchronize()
    launches = sf.launches
    sk = trainer.history[-1]
    del trainer
    print(f"resnet50 SK step on {report['card']}: sk_time "
          f"{sk['sk_time']:.4f} s, fused SK launches {launches}, SK {sk}",
          flush=True)
    check(ran and math.isfinite(sk["sk_cost"]), "resnet50: an SK step")
    sk_split_line("resnet50", sk, report)
    check(launches > 0 and launches == sk["sk_iters_total"],
          "resnet50: one fused SK launch per solver iteration")


def loader_modes_path(torch, sf, device, report, tmp):
    """Phase 3b: the CLI at full width with spawned loader workers, data
    echo 2 and coalesced transfers (one epoch, BN warmup, one SK step with
    matching). Every step trains, each loaded batch twice; the workers stop
    when the run ends."""
    import multiprocessing

    from selavi_tpu_torch.cli import main as cli_main
    from selavi_tpu_torch.train import loop

    argv = MAIN_ARGS.split() + LOADER_MODE_ARGS.split() + [
        "--dump_path", os.path.join(tmp, "modes")]
    rec = {"steps": 0, "epoch_s": 0.0, "sk_s": 0.0, "batches": []}

    class Timed(loop.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner = self.train_step

            def train_step(batch, labels, gen):
                rec["steps"] += 1
                rec["batches"].append(batch["index"].clone())  # no sync
                return inner(batch, labels, gen)

            self.train_step = train_step

        def maybe_cluster(self, iteration):
            # synchronised only when the SK step ran: a sync on every call
            # would charge the steps queued before it to the SK step
            t0 = time.perf_counter()
            ran = super().maybe_cluster(iteration)
            if ran:
                torch.cuda.synchronize()
                rec["sk_s"] += time.perf_counter() - t0
            return ran

        def train_epoch(self, epoch):
            rec["steps"] = 0
            t0 = time.perf_counter()
            out = super().train_epoch(epoch)
            torch.cuda.synchronize()
            rec["epoch_s"] = time.perf_counter() - t0
            return out

    sf.reset_launches()
    t0 = time.perf_counter()
    code, trainer = _run_cli(cli_main, argv, Timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sf.launches
    loaded = len(trainer.loader)
    clips = trainer.loader.batch_size
    pool_closed = trainer.loader._pool is None
    sk = [h for h in trainer.history if "sk_cost" in h]
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    del trainer
    alive = multiprocessing.active_children()
    train_s = rec["epoch_s"] - rec["sk_s"]
    report["modes_epoch_clips_per_s"] = rec["steps"] * clips / train_s
    print(f"loader-modes CLI run ({LOADER_MODE_ARGS}): {wall:.1f} s, exit "
          f"{code}, steps {rec['steps']} ({loaded} loaded batches x 2), SK "
          f"steps {len(sk)}, fused SK launches {launches}, sk_time "
          f"{sk[0]['sk_time'] if sk else None}; epoch {rec['epoch_s']:.2f} "
          f"s of which SK {rec['sk_s']:.2f} s: "
          f"{report['modes_epoch_clips_per_s']:.2f} clips/s trained "
          f"({report['modes_epoch_clips_per_s'] / 2:.2f} clips/s loaded); "
          f"workers stopped {pool_closed and not alive}", flush=True)
    check(code is None, "the loader-modes run returns (exit 0)")
    check(rec["steps"] == 2 * loaded, "data echo 2: two steps a batch")
    check(all(torch.equal(a, b) for a, b in zip(rec["batches"][0::2],
                                                rec["batches"][1::2])),
          "each loaded batch trains twice in a row")
    check(len(sk) == 1 and math.isfinite(sk[0]["sk_cost"]),
          "one SK step, finite cost")
    check(all(math.isfinite(x) for x in losses), "losses finite")
    check(launches > 0 and launches == sk[0]["sk_iters_total"],
          f"one fused SK launch per solver iteration: {launches} launches, "
          f"{sk[0]['sk_iters_total']} iterations")
    check(pool_closed and not alive, f"worker processes stopped: {alive}")
    sk_split_line("loader modes", sk[0], report)
    report["modes_launches"] = launches


def dual_data_path(torch, sf, device, report, tmp):
    """Phase 3c: ``--dual_data true`` at full width (batch 24, two 30-frame
    clips a sample, a 2-channel audio stem) on DUAL_SAMPLES synthetic
    samples through the CLI: BN warmup, one SK step, an epoch of train
    steps; then the step on a resident batch and the peak memory."""
    from selavi_tpu_torch.cli import main as cli_main
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.train import loop

    argv = MAIN_ARGS.split() + [
        "--dual_data", "true", "--num_data_samples", str(DUAL_SAMPLES),
        "--dump_path", os.path.join(tmp, "dual")]
    fed = []

    class Recorded(loop.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            for net in (self.model.video_network, self.model.audio_network):
                net.register_forward_pre_hook(
                    lambda mod, inp: fed.append((type(mod).__name__,
                                                 tuple(inp[0].shape),
                                                 mod.training)))

    torch.cuda.reset_peak_memory_stats()
    sf.reset_launches()
    t0 = time.perf_counter()
    code, trainer = _run_cli(cli_main, argv, Recorded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sf.launches
    sk = [h for h in trainer.history if "sk_cost" in h]
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    stem = tuple(trainer.model.audio_network.stem.conv.weight.shape)
    del trainer
    cli_peak = torch.cuda.max_memory_allocated() / 1e9
    train_fed = sorted({(n, s) for n, s, training in fed if training})
    print(f"dual_data CLI run (--dual_data true, {DUAL_SAMPLES} samples): "
          f"{wall:.1f} s, exit {code}, SK steps {len(sk)}, fused SK "
          f"launches {launches}, audio stem {stem}, fed in train mode "
          f"{train_fed}", flush=True)
    check(code is None, "the dual_data run returns (exit 0)")
    check(stem[1] == 2, "a 2-channel audio stem")
    check(train_fed == [("AudioResNet", (24, 257, 99, 2)),
                        ("R2Plus1D18", (24, 60, 112, 112, 3))],
          "two clips a sample reach both towers")
    check(len(sk) == 1 and math.isfinite(sk[0]["sk_cost"])
          and launches == sk[0]["sk_iters_total"] > 0,
          "one SK step, one fused launch per iteration")
    check(all(math.isfinite(x) for x in losses), "dual losses finite")
    sk_split_line("dual_data", sk[0], report)

    args = parse_arguments().parse_args(argv)
    fresh = loop.Trainer(args, build_dataset(args))
    time_train(torch, fresh, report, prefix="dual_", epoch=False)
    print(f"dual_data train on {report['card']}: "
          f"{report['dual_train_clips_per_s']:.2f} samples/s (train step on "
          f"a resident batch of 24 samples, 2 x 30 frames each, bf16), "
          f"peak memory {report['dual_peak_mem_gb']:.2f} GB in the step, "
          f"{cli_peak:.2f} GB over the CLI run", flush=True)
    del fresh


def trace_split(torch, trace_path, traces, report, key="trace"):
    """The traced epoch's device time: the ten device operations (kernels,
    copies, fills) that took the most, from the Chrome trace the CLI
    wrote, and the ten host ops whose kernels took the most, from
    ``key_averages()``."""
    import json

    check(os.path.isfile(trace_path), f"the trace {trace_path} exists")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sum(e["cat"] == "kernel" for e in device)
    check(kernels > 0, "the trace holds CUDA kernel events")
    by_name: dict = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total = sum(by_name.values())
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = (max(e["ts"] + e["dur"] for e in timed)
              - min(e["ts"] for e in timed))
    print(f"traced epoch on {report['card']}: {kernels} kernels, "
          f"{len(device) - kernels} copies and fills, device time "
          f"{total / 1e3:.1f} ms, device busy {busy / 1e3:.1f} of "
          f"{window / 1e3:.1f} ms traced ({busy / window * 100:.1f}%; idle "
          f"{100 - busy / window * 100:.1f}%); trace "
          f"{os.path.getsize(trace_path)} bytes", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device op {us / 1e3:9.2f} ms {us / total * 100:5.1f}%  "
              f"{name[:150]}", flush=True)
    report[key] = {"device_ms": total / 1e3, "busy_ms": busy / 1e3,
                   "window_ms": window / 1e3}
    check(len(traces) == 1, "one traced epoch")
    rows = [e for e in traces[0].key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and getattr(e, "self_device_time_total", 0) > 0]
    op_total = sum(e.self_device_time_total for e in rows)
    print(f"host ops by the device time of their own kernels "
          f"(key_averages): {op_total / 1e3:.1f} ms in {len(rows)} ops",
          flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  host op {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / max(op_total, 1e-9) * 100:5.1f}%"
              f"  {e.key} x{e.count}", flush=True)


def time_train(torch, trainer, report, prefix="", epoch=True):
    """Phase 4b: train clips/s, on a device-resident batch as the loader
    gives it (a wire-format batch is decoded in the timed step) and, with
    ``epoch``, over a full epoch. Returns the resident batch."""
    from selavi_tpu_torch.data.loader import decode_wire_batch

    torch.cuda.reset_peak_memory_stats()
    batch = next(iter(trainer.loader))
    labels = torch.zeros(batch["index"].shape[0], trainer.args.headcount,
                         dtype=torch.long, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    for _ in range(3):
        trainer.train_step(decode_wire_batch(batch), labels, gen)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(decode_wire_batch(batch), labels, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    clips = batch["index"].shape[0]
    report[prefix + "train_clips_per_s"] = clips / step_s
    report[prefix + "peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not epoch:
        return batch
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    n_epoch = trainer.batches_per_epoch * clips
    report[prefix + "epoch_clips_per_s"] = n_epoch / epoch_s
    return batch


def frontend_and_yuv(torch, device, report):
    """Phase 6: the card's audio frontend (``prepare_audio`` on int16-range
    PCM) against the host's numpy float64 ``get_spec`` of each clip (the
    host's native route timed beside it), and the card's YUV 4:2:0 decode
    against its CPU result, bit for bit."""
    import numpy as np

    from selavi_tpu_torch.data.audio import get_spec
    from selavi_tpu_torch.measure import cuda_ms
    from selavi_tpu_torch.ops.preprocess import yuv420_to_rgb_batch
    from selavi_tpu_torch.train.step import prepare_audio

    rng = np.random.default_rng(9)
    t = np.arange(PCM_SAMPLES) / FRONTEND_CFG["samplerate"]
    tone = 6000 * np.sin(2 * np.pi * rng.uniform(100, 8000, (24, 1)) * t)
    pcm = np.clip(np.round(tone + rng.standard_normal((24, PCM_SAMPLES))
                           * 3000), -32768, 32767).astype(np.int16)

    def host_specs():
        t0 = time.perf_counter()
        out = np.stack([get_spec(clip, 0.0, num_sec=1, sample_rate=48000,
                                 aud_spec_type=2, z_normalize=True)[0]
                        for clip in pcm])
        return out, (time.perf_counter() - t0) * 1e3

    native_spec, native_ms = host_specs()
    with numpy_host():
        host, host_ms = host_specs()
    native_err = float(np.abs(native_spec - host).max())
    pcm_dev = torch.from_numpy(pcm).to(device)
    spec = prepare_audio(pcm_dev, torch.float32, FRONTEND_CFG)
    torch.cuda.synchronize()
    check(spec.shape == (24, 257, 99, 1) and spec.dtype == torch.float32
          and spec.device == device, f"the frontend's output {spec.shape}")
    got = spec[..., 0].cpu().numpy()
    err = np.abs(got - host)
    within = bool((err <= FRONTEND_ATOL + FRONTEND_RTOL * np.abs(host)).all())
    ms = cuda_ms(lambda: prepare_audio(pcm_dev, torch.float32, FRONTEND_CFG),
                 reps=20)
    print(f"audio frontend on {report['card']}: 24 clips of {PCM_SAMPLES} "
          f"int16 samples -> [24, 257, 99, 1] in {ms:.4f} ms per batch on "
          f"the card (the host's get_spec: {native_ms:.1f} ms native, "
          f"{host_ms:.1f} ms numpy); max |card - host numpy| "
          f"{err.max():.3g} (tolerance {FRONTEND_ATOL} + {FRONTEND_RTOL} x "
          f"|host|), within {within}; max |host native - host numpy| "
          f"{native_err:.3g}", flush=True)
    check(bool(np.isfinite(got).all()), "the frontend's output is finite")
    check(within, "the card's frontend matches the host's spectrogram")
    report["frontend_ms"] = ms
    report["host_spec_ms"] = {"native": native_ms, "numpy": host_ms}

    y = torch.randint(0, 256, (24, 30, 112, 112), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    uv = torch.randint(0, 256, (24, 30, 56, 56, 2), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(2))
    ref = yuv420_to_rgb_batch(y, uv)
    y_dev, uv_dev = y.to(device), uv.to(device)
    rgb = yuv420_to_rgb_batch(y_dev, uv_dev)
    same = rgb.device == device and torch.equal(rgb.cpu(), ref)
    ms = cuda_ms(lambda: yuv420_to_rgb_batch(y_dev, uv_dev), reps=20)
    print(f"YUV 4:2:0 decode on {report['card']}: [24, 30, 112, 112] -> "
          f"{list(rgb.shape)} uint8 in {ms:.4f} ms on the card; equal to "
          f"the CPU result {same}", flush=True)
    check(same, "the card's YUV decode equals the CPU's bit for bit")


def conv_kernel_origins(prof, parts=("f32f32", "ffma")):
    """The host ops that launched the kernels whose names hold every one of
    ``parts``, with their input shapes and dtypes (the trace records them)
    and their callers: which layer runs each such kernel. Returns the
    device ms by (kernel, launching chain)."""
    found: dict = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if not all(p in k.name for p in parts):
                continue
            chain, p = [], e
            while p is not None and len(chain) < 7:
                shapes = [list(s) for s in (p.input_shapes or ()) if s]
                types = [t for t in (getattr(p, "input_dtypes", None) or ())
                         if t and t[0].isalpha() and "Scalar" not in t]
                chain.append(f"{p.name}{shapes if shapes else ''}"
                             f"{types if types else ''}")
                p = p.cpu_parent
            key = (k.name, " <- ".join(chain))
            found[key] = found.get(key, 0.0) + k.duration / 1e3
    total = sum(found.values())
    print(f"kernels named {'*'.join(parts)}: {total:.2f} ms of device time "
          f"in {len(found)} (kernel, launching op) pairs", flush=True)
    for (name, chain), ms in sorted(found.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.2f} ms  {name[:110]}\n      launched by {chain}",
              flush=True)
    return found


def packed_path(torch, sf, device, report, tmp):
    """Phase 7: the packed path at full width. The port's pack CLI writes
    the shard; the pretraining CLI trains one epoch on it (BN warmup, one
    SK step); a fresh Trainer restored from its checkpoint times the step
    on a resident wire-format batch and an epoch; the CLI resumed with
    ``--trace_profile true`` traces epoch 1 with the ops' input shapes."""

    from selavi_tpu_torch.cli import main as cli_main
    from selavi_tpu_torch.cli import pack_dataset
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.data.packed import PackedAVDataset
    from selavi_tpu_torch.train import loop
    from selavi_tpu_torch.train import step as steps
    from selavi_tpu_torch.train.checkpoint import CKPT_NAME
    from selavi_tpu_torch.utils import profiling

    shard = os.path.join(tmp, "synthetic_vggsound_recipe.pack")
    samples = parse_arguments().parse_args(MAIN_ARGS.split()).num_data_samples
    t0 = time.perf_counter()
    meta = pack_dataset.main(MAIN_ARGS.split() + PACK_ARGS.split()
                             + ["--output", shard])
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(shard)
    print(f"packed shard on {report['card']}: {meta['n']} samples, video "
          f"{meta['video_shape']} {meta['video_format']}, pcm "
          f"{meta['pcm_len']} {meta['pcm_dtype']}, {nbytes} bytes written "
          f"in {write_s:.1f} s ({nbytes / write_s / 1e6:.1f} MB/s)",
          flush=True)
    check(meta["n"] == samples and meta["video_shape"] == PACK_SHAPE
          and meta["pcm_len"] == PCM_SAMPLES
          and meta["video_format"] == "yuv420"
          and meta["pcm_dtype"] == "int16", f"the shard's layout {meta}")
    report["pack_write_s"], report["pack_bytes"] = write_s, nbytes

    dump = os.path.join(tmp, "run")
    argv = MAIN_ARGS.split() + ["--ds_name", "packed", "--root_dir", shard,
                                "--train_crop_size", "112", "--dump_path",
                                dump]
    fed, frontend = [], []
    prepare_audio = steps.prepare_audio

    def recorded_prepare_audio(audio, *a, **kw):
        out = prepare_audio(audio, *a, **kw)
        frontend.append((tuple(audio.shape), audio.device, tuple(out.shape),
                         out.device))
        return out

    class Recorded(loop.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.audio_network.register_forward_pre_hook(
                lambda mod, inp: fed.append((tuple(inp[0].shape),
                                             inp[0].device,
                                             mod.training)))

    sf.reset_launches()
    steps.prepare_audio = recorded_prepare_audio
    try:
        t0 = time.perf_counter()
        code, trainer = _run_cli(cli_main, argv, Recorded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        steps.prepare_audio = prepare_audio
    launches = sf.launches
    history = trainer.history
    dataset = trainer.dataset
    del trainer
    sk = [h for h in history if "sk_cost" in h]
    losses = [h["loss"] for h in history if "loss" in h]
    train_fed = {s for s, d, training in fed if training}
    pcm_in = {(a, o) for a, ad, o, od in frontend
              if len(a) == 2 and ad == device and od == device}
    saved = torch.load(os.path.join(dump, CKPT_NAME), map_location="cpu",
                       weights_only=True)
    print(f"packed CLI run (--ds_name packed, --epochs 1): {wall:.1f} s, "
          f"exit {code}, SK steps {len(sk)}, "
          f"SK {sk[0] if sk else None}, fused SK launches {launches}, "
          f"checkpoint epoch {saved['epoch']}; the card's frontend "
          f"{sorted(pcm_in)}, the audio stem fed {sorted(train_fed)} in "
          f"train mode", flush=True)
    check(code is None, "the packed run returns (exit 0)")
    check(isinstance(dataset, PackedAVDataset), "the CLI built the shard")
    check(saved["epoch"] == 1, "the packed run's checkpoint")
    check(len(sk) == 1 and math.isfinite(sk[0]["sk_cost"]),
          "one SK step, finite cost")
    check(all(math.isfinite(x) for x in losses), "packed losses finite")
    check(launches > 0 and launches == sk[0]["sk_iters_total"],
          f"one fused SK launch per solver iteration on the packed path: "
          f"{launches} launches, {sk[0]['sk_iters_total']} iterations")
    check(((24, PCM_SAMPLES), (24, 257, 99, 1)) in pcm_in,
          "the card turned [24, 48000] PCM into [24, 257, 99, 1]")
    check(train_fed == {(24, 257, 99, 1)}
          and all(d == device for _, d, _ in fed),
          "the audio stem was fed [24, 257, 99, 1] on the card")
    sk_split_line("packed", sk[0], report)
    report["packed_launches"] = launches

    args = parse_arguments().parse_args(argv)
    fresh = loop.Trainer(args, build_dataset(args))
    check(fresh.resume() == 1 and len(fresh.sk_schedule) == 1,
          "the restored Trainer starts at epoch 1 with no SK step left")
    batch = time_train(torch, fresh, report, prefix="packed_")
    check(batch["video_y"].dtype == torch.uint8
          and batch["audio_pcm"].dtype == torch.int16
          and batch["video_y"].device == device,
          "the resident batch is uint8 YUV and int16 PCM on the card")
    print(f"packed train on {report['card']}: "
          f"{report['packed_train_clips_per_s']:.2f} clips/s (train step on "
          f"a resident uint8 YUV + int16 PCM batch, decoded in the step, "
          f"bf16), {report['packed_epoch_clips_per_s']:.2f} clips/s (epoch "
          f"from the shard)", flush=True)
    del fresh, batch

    traces = []

    @contextlib.contextmanager
    def keep_trace(dump_path, enabled=True):
        with profiling.trace_window(dump_path, enabled,
                                    record_shapes=True) as prof:
            yield prof
        if prof is not None:
            traces.append(prof)

    sf.reset_launches()
    loop.trace_window = keep_trace
    try:
        code, trainer = _run_cli(
            cli_main, argv + ["--epochs", "2", "--trace_profile", "true"],
            loop.Trainer)
        torch.cuda.synchronize()
    finally:
        loop.trace_window = profiling.trace_window
    epochs = [h["epoch"] for h in trainer.history if "iter" not in h]
    del trainer
    print(f"packed CLI run 2 (--trace_profile true): exit {code}, epochs "
          f"trained {epochs}, fused SK launches {sf.launches}", flush=True)
    check(code is None and epochs == [1] and sf.launches == 0,
          "the traced packed run resumes at epoch 1 with no SK step")
    trace_split(torch, os.path.join(dump, "profile", profiling.TRACE_NAME),
                traces, report, key="packed_trace")
    t = report["packed_trace"]
    print(f"packed traced epoch on {report['card']}: device busy "
          f"{t['busy_ms'] / t['window_ms'] * 100:.1f}% of the traced "
          f"epoch", flush=True)
    conv_kernel_origins(traces[0])


def conv_kernels_vs_plain(torch, conv, device, report):
    """Phase 2c: the conv kernels against their plain versions on the card,
    at the probe's check shapes, the ragged shapes and the bench shape, in
    fp32 and bf16; every kernel must be bit-identical on repeat and go
    through the route its shape names."""
    from selavi_tpu_torch.experiments.conv3x3 import BENCH_SHAPE, CHECK_SHAPES

    worst = {name: 0.0 for name, _ in CONV_KERNELS}
    gen = torch.Generator(device=device).manual_seed(0)
    lib = conv._library()
    for shape in CHECK_SHAPES + tuple(CONV_RAGGED_SHAPES) + (BENCH_SHAPE,):
        n, h, wd, c, co = shape
        for cin, cout in ((c, co), (co, c)):
            check(lib.conv3x3_fwd_wgmma_smem(cin, cout)
                  == conv.fwd_smem_bytes(cin, cout),
                  f"the wgmma forward's shared memory at {cin} -> {cout}")
            check(lib.conv3x3_f32_smem(0, cout)
                  == conv.f32_smem_bytes("forward", cout),
                  f"the fp32 forward's shared memory at {cin} -> {cout}")
        check(lib.conv3x3_f32_smem(1, co) == conv.f32_smem_bytes("wgrad"),
              "the fp32 weight gradient's shared memory")
        x32 = torch.randn(n, h, wd, c, generator=gen, device=device)
        w32 = 0.1 * torch.randn(3, 3, c, co, generator=gen, device=device)
        g32 = torch.randn(n, h, wd, co, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g = (t.to(dtype) for t in (x32, w32, g32))
            cases = (
                ("conv3x3", conv.conv3x3, conv.conv3x3_plain, (x, w)),
                ("conv3x3_dgrad", conv.conv3x3_dgrad,
                 conv.conv3x3_dgrad_plain, (g, w)),
                ("conv3x3_wgrad", conv.conv3x3_wgrad,
                 conv.conv3x3_wgrad_plain, (x, g)),
            )
            bf16_routes = dict(zip(
                (name for name, _ in CONV_KERNELS),
                CONV_RAGGED_SHAPES.get(shape, ("wgmma",) * 3)))
            for name, kernel, plain, args in cases:
                route = "fp32" if dtype == torch.float32 else \
                    bf16_routes[name]
                routes = conv.wgrad_routes if name == "conv3x3_wgrad" else \
                    conv.fwd_routes[name]
                terms = n * h * wd if name == "conv3x3_wgrad" else \
                    9 * args[0].shape[3]
                rtol = CONV_FP32_RTOL * math.sqrt(
                    max(1.0, terms / CONV_FP32_TERMS))
                if name != "conv3x3_wgrad" and dtype == torch.bfloat16:
                    rtol += BF16_ULP
                conv.reset_launches()
                got = kernel(*args)
                check(routes == {r: int(r == route) for r in conv.ROUTES},
                      f"{name} {shape} {dtype} ran on {route}: {routes}")
                ref = plain(*args)
                again = kernel(*args)
                torch.cuda.synchronize()
                diff = float((got.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                same = torch.equal(got, again)
                print(f"conv kernel vs plain {name} {shape} "
                      f"{str(dtype)[6:]} ({route}): max|diff| {diff:.3g} "
                      f"(scale {scale:.3g}, tolerance {rtol:.3g} of scale), "
                      f"repeat "
                      f"bit-identical {same}", flush=True)
                check(got.dtype == ref.dtype and got.shape == ref.shape,
                      f"{name} {shape} {dtype}: dtype and shape")
                check(bool(torch.isfinite(got).all()),
                      f"{name} {shape} {dtype}: finite")
                check(diff <= rtol * scale, f"{name} {shape} {dtype}")
                check(same, f"{name} {shape} {dtype}: deterministic")
                worst[name] = max(worst[name], diff)
            del x, w, g, got, ref, again
        del x32, w32, g32
    report["conv_max_abs_err"] = worst


def conv_probe_path(torch, conv, measure, device, report):
    """Phase 5: the conv probe's entry point (check, then bench); every
    conv kernel count must move, and the bench shape's bf16 forward, dgrad
    and weight gradient must go through their wgmma kernels."""
    from selavi_tpu_torch.experiments import conv3x3 as probe

    conv.reset_launches()
    probe.check(device)
    bench = probe.bench(device)
    torch.cuda.synchronize()
    # The fp32 bound assumes the boost clock: the clock the card ran at.
    print(f"SM clock after the bench (clocks.sm, clocks.max.sm): "
          f"{measure.sm_clocks()}", flush=True)
    launches = dict(conv.launches)
    routes = dict(conv.wgrad_routes)
    fwd_routes = {name: dict(r) for name, r in conv.fwd_routes.items()}
    print(f"conv probe path: launches {launches}, forward routes "
          f"{fwd_routes['conv3x3']}, dgrad routes "
          f"{fwd_routes['conv3x3_dgrad']}, weight-gradient routes "
          f"{routes}", flush=True)
    for name, _ in CONV_KERNELS:
        check(launches[name] > 0, f"the probe path launched {name}")
    n, h, wd, c, co = probe.BENCH_SHAPE
    # The probe's only bf16 forwards and dgrads are bench()'s, at the bench
    # shape: all of them on wgmma (BN = 128 forward, BN = 64 dgrad).
    for name, (cin, cout) in (("conv3x3", (c, co)),
                              ("conv3x3_dgrad", (co, c))):
        r = fwd_routes[name]
        check(conv.fwd_route(torch.bfloat16, cin, cout) == "wgmma",
              f"the bench shape's bf16 {name} routes to wgmma")
        check(r["wgmma"] > 0 and r["wmma"] == 0 and r["fp32"] > 0,
              f"the probe path's {name} routes: {r}")
        check(sum(r.values()) == launches[name],
              f"{name} routes add up to its launches")
    check(conv.wgrad_route(torch.bfloat16, c, co) == "wgmma",
          "the bench shape's bf16 weight gradient routes to wgmma")
    # C and Co fill whole tiles there: the split-K scratch is exactly the S
    # partials of [9, C, Co] (13 MB at S = 44).
    splits, _ = conv.split_plan("wgmma", n * h * wd, c, co)
    check(conv._library().conv3x3_wgrad_scratch(c, co, splits)
          == splits * 9 * c * co, "the bench shape's split-K scratch")
    # The probe's only bf16 weight gradients are bench()'s, at the bench
    # shape: all of them went through wgmma, none through wmma.
    check(routes["wgmma"] > 0 and routes["wmma"] == 0,
          "the probe path's bf16 weight gradients ran on wgmma")
    check(routes["fp32"] > 0, "the probe path ran the fp32 weight gradient")
    check(sum(routes.values()) == launches["conv3x3_wgrad"],
          "weight-gradient routes add up to its launches")
    report["conv_launches"] = launches
    report["conv_fwd_routes"] = fwd_routes
    report["conv_bench"] = bench


def _restore_process_state():
    """Put back the log and signal handlers that a CLI run installs."""
    root = logging.getLogger()
    for handler in root.handlers:
        handler.close()
    root.handlers.clear()
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from selavi_tpu_torch import measure, native
    from selavi_tpu_torch.ops import _build
    from selavi_tpu_torch.ops import conv3x3 as conv
    from selavi_tpu_torch.ops import sinkhorn_fused as sf

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    t_start = time.perf_counter()
    card = measure.card_description()
    print(f"card: {card}", flush=True)
    report: dict = {"card": card}
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    # fp32 comparisons in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off", flush=True)
    device = torch.device("cuda", 0)

    # One nvcc per source and g++ for the host data runtime, started
    # together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda m: m.build_library(),
                             (sf, conv, native)))
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"host data runtime: {libs[2].name} (g++ "
          f"{' '.join(_build.GXX_FLAGS)}), available {native.available()}",
          flush=True)
    check(native.available(), "the host data runtime loads")

    inputs = kernel_vs_plain(torch, sf, device, report)
    solver_fused_vs_plain(torch, sf, device, report)
    conv_kernels_vs_plain(torch, conv, device, report)
    frontend_and_yuv(torch, device, report)
    from selavi_tpu_torch.data import decoder

    print(f"real-media decoders found: have_pyav "
          f"{decoder.have_pyav()}, have_ffmpeg {decoder.have_ffmpeg()}, "
          f"have_cv2 {decoder.have_cv2()}", flush=True)
    # The CLI writes its runs into directories outside the checkout.
    dump = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        trainer = cli_path(torch, sf, device, report, dump)
        eval_path(torch, device, report, dump)
        # the rest of the evaluation suite on run 2's checkpoint; none of
        # it launches a hand kernel
        sf.reset_launches()
        conv.reset_launches()
        t_suite = time.perf_counter()
        suite = tempfile.mkdtemp(prefix="chip_smoke_eval_suite_")
        try:
            pth_import_path(torch, device, report, dump, suite)
            cluster_vis_path(report, dump, suite)
            ucf = make_ucf_tree(suite)
            retrieval_path(torch, device, report, dump, ucf, suite)
            finetune_path(torch, device, report, dump, ucf, suite)
        finally:
            shutil.rmtree(suite, ignore_errors=True)
        suite_launches = sf.launches + sum(conv.launches.values())
        print(f"evaluation suite (.pth import, cluster_vis, retrieval, "
              f"finetuning): {time.perf_counter() - t_suite:.1f} s, hand "
              f"kernel launches {suite_launches}", flush=True)
        check(suite_launches == 0, "the evaluation suite runs no hand kernel")
    finally:
        _restore_process_state()
        shutil.rmtree(dump, ignore_errors=True)
    for phase in (loader_modes_path, dual_data_path, packed_path,
                  sk_cache_path, resnet50_path):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase.__name__}_")
        try:
            phase(torch, sf, device, report, tmp)
        finally:
            _restore_process_state()
            shutil.rmtree(tmp, ignore_errors=True)
    conv_probe_path(torch, conv, measure, device, report)

    # Phase 4a: the SK kernel at paper scale, against its byte bound.
    bw = measure.memory_bandwidth(device)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs[(PAPER_N, PAPER_K, dtype)]
        m = args[0]
        # As the solver calls it: outputs and scratch made once.
        out = (torch.empty_like(args[1]), torch.empty_like(args[2]),
               torch.empty((), device=device))
        ws = sf.make_workspace(m)
        nbytes = (m.numel() * m.element_size() + 2 * 4 * PAPER_N
                  + 3 * 4 * PAPER_K + 4)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = OPS_PER_ELEMENT * m.numel() / measure.FP32_PEAK_FLOPS * 1e3
        times[dtype] = {
            "ms": measure.cuda_ms(lambda: sf.fused_sk_iteration(
                *args, out=out, workspace=ws)),
            "plain_ms": measure.cuda_ms(
                lambda: sf.fused_sk_iteration_plain(*args), reps=20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes,
        }
        t = times[dtype]
        print(f"fused SK iteration {PAPER_N}x{PAPER_K} {str(dtype)[6:]} on "
              f"{card}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} "
              f"({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s), "
              f"{t['bound_ms'] / t['ms'] * 100:.1f}% of bound; no single "
              f"PyTorch call computes this iteration (library_ms null)",
              flush=True)
        # The host's part of an iteration: enqueueing runs ahead of the
        # card, which takes longer for each.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            sf.fused_sk_iteration(*args, out=out, workspace=ws)
        t["host_us"] = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        print(f"fused SK iteration {PAPER_N}x{PAPER_K} {str(dtype)[6:]}: "
              f"{t['host_us']:.2f} us of host time to enqueue one",
              flush=True)
    print(f"SK solver {PAPER_N}x{PAPER_K} fused on {card}: fp32 "
          f"{report['solver_it_per_s']:.1f} it/s, bf16 "
          f"{report['solver_it_per_s_bf16']:.1f} it/s; kernel bf16/fp32 "
          f"{times[torch.bfloat16]['ms'] / times[torch.float32]['ms']:.3f}",
          flush=True)

    time_train(torch, trainer, report)
    # the same epoch with the host's numpy twins of the data runtime
    with numpy_host():
        t0 = time.perf_counter()
        trainer.train_epoch(1)
        torch.cuda.synchronize()
    numpy_epoch = (trainer.batches_per_epoch * trainer.loader.batch_size
                   / (time.perf_counter() - t0))
    # and with the recipe's 8 workers as spawned processes: the first
    # epoch starts them, the second finds them running
    trainer.loader.worker_mode = "process"
    process_epochs = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            trainer.train_epoch(1)
            torch.cuda.synchronize()
            process_epochs.append(trainer.batches_per_epoch
                                  * trainer.loader.batch_size
                                  / (time.perf_counter() - t0))
    finally:
        trainer.loader.close()
    print(f"train on {card}: {report['train_clips_per_s']:.2f} clips/s "
          f"(train step, device-resident batch, bf16), "
          f"{report['epoch_clips_per_s']:.2f} clips/s (epoch with the "
          f"synthetic host loader, native host runtime, 8 threads), "
          f"{numpy_epoch:.2f} clips/s (the next epoch, numpy host runtime), "
          f"{process_epochs[0]:.2f} and {process_epochs[1]:.2f} clips/s (the "
          f"next two, native, on 8 spawned worker processes, started in the "
          f"first), peak memory {report['peak_mem_gb']:.2f} GB in the step "
          f"and the first epoch", flush=True)

    fp32 = times[torch.float32]
    kernels = [{
        "name": "fused_sk_iteration",
        "route": "cuda",
        "source": "selavi_tpu_torch/csrc/fused_sk.cu",
        "replaces": "selavi_tpu/ops/sinkhorn_pallas.py:97",
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"],
        "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"],
        "library_ms": None,
    }]
    # The conv kernels at the probe's bench shape in bf16, as it times them.
    for name, replaces in CONV_KERNELS:
        t = report["conv_bench"][(name, "bfloat16")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "selavi_tpu_torch/csrc/conv3x3.cu",
            "replaces": replaces,
            "launches": report["conv_launches"][name],
            "max_abs_err": report["conv_max_abs_err"][name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
