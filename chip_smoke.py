#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``selavi_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources
(``selavi_tpu_torch/csrc/{fused_sk,conv3x3}.cu`` into
``build/selavi_tpu_torch/``, one ``nvcc`` per source, started together),
holds each kernel against its plain PyTorch version on the card, and drives
the port's two paths with the launch counts set to 0 just before and read
just after each:
- the main path: the pretraining CLI (``selavi_tpu_torch.cli.main``) at the
  full width of the reference VGG-Sound recipe, on a temporary
  ``--dump_path`` outside the checkout, in two runs. Run 1 (BN warmup,
  epoch 0 with one Sinkhorn-Knopp re-clustering, which runs the fused SK
  kernel, and its checkpoint) gets SIGUSR1 early in epoch 1 and must exit
  0 with a checkpoint stamped epoch 1; its checkpoint restores into a
  fresh Trainer bit for bit; run 2, the same command with
  ``--trace_profile true``, resumes at epoch 1 with no warmup and no SK
  step, trains it under the profiler and writes its checkpoint. The
  checkpoint's save, write and restore times and size, and the traced
  epoch's device time by operation, are printed;
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
Then it times the SK kernel and the train step. For the SK kernel it also
holds the library's tiling (``sk_plan``) against ``plan()`` at every shape
it compares, checks that an M off a 16-byte boundary is refused and that
the solver and the main path launch the kernel once an iteration, and
prints the kernel's registers and spills, its grid, the host's time to
enqueue an iteration and the solver's it/s at paper scale in fp32 and
bf16. Every phase raises on failure, so any failure exits non-zero. Standard output ends with a line
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
# The packed path: the same recipe from a shard that stores the video at
# the top of train_scale_range(112) in YUV 4:2:0 and the audio as int16 PCM.
PACK_ARGS = ("--train_crop_size 160 --pack_video_format yuv420 "
             "--pack_pcm_dtype int16")
PACK_SHAPE = [30, 160, 160, 3]
PCM_SAMPLES = 48000  # one second at 48 kHz
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
    import os
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
    t0 = time.perf_counter()
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


def trace_split(torch, trace_path, traces, report, key="trace"):
    """The traced epoch's device time: the ten device operations (kernels,
    copies, fills) that took the most, from the Chrome trace the CLI
    wrote, and the ten host ops whose kernels took the most, from
    ``key_averages()``."""
    import json
    import os

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


def time_train(torch, trainer, report, prefix=""):
    """Phase 4b: train clips/s, on a device-resident batch as the loader
    gives it (a wire-format batch is decoded in the timed step) and over a
    full epoch. Returns the resident batch."""
    from selavi_tpu_torch.data.loader import decode_wire_batch

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
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    n_epoch = trainer.batches_per_epoch * clips
    report[prefix + "train_clips_per_s"] = clips / step_s
    report[prefix + "epoch_clips_per_s"] = n_epoch / epoch_s
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return batch


def frontend_and_yuv(torch, device, report):
    """Phase 6: the card's audio frontend (``prepare_audio`` on int16-range
    PCM) against the host's numpy ``get_spec`` of each clip, and the card's
    YUV 4:2:0 decode against its CPU result, bit for bit."""
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
    t0 = time.perf_counter()
    host = np.stack([get_spec(clip, 0.0, num_sec=1, sample_rate=48000,
                              aud_spec_type=2, z_normalize=True)[0]
                     for clip in pcm])
    host_ms = (time.perf_counter() - t0) * 1e3
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
          f"the card (the host's numpy get_spec: {host_ms:.1f} ms); max "
          f"|card - host| {err.max():.3g} (tolerance {FRONTEND_ATOL} + "
          f"{FRONTEND_RTOL} x |host|), within {within}", flush=True)
    check(bool(np.isfinite(got).all()), "the frontend's output is finite")
    check(within, "the card's frontend matches the host's spectrogram")
    report["frontend_ms"] = ms

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
    import os

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
    from selavi_tpu_torch import measure
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

    # One nvcc per source, started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build_library(), (sf, conv)))
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
    finally:
        _restore_process_state()
        shutil.rmtree(dump, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_packed_")
    try:
        packed_path(torch, sf, device, report, tmp)
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
    print(f"train on {card}: {report['train_clips_per_s']:.2f} clips/s "
          f"(train step, device-resident batch, bf16), "
          f"{report['epoch_clips_per_s']:.2f} clips/s (epoch with the "
          f"synthetic host loader), peak memory "
          f"{report['peak_mem_gb']:.2f} GB", flush=True)

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
