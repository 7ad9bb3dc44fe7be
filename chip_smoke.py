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
- the main path: the Trainer (BN warmup, one Sinkhorn-Knopp re-clustering
  with modality matching, an epoch of train steps) at the full width of
  the reference VGG-Sound recipe, which runs the fused SK kernel;
- the conv probe: ``selavi_tpu_torch.experiments.conv3x3``'s ``check()``
  and ``bench()``, which run the conv3x3 forward, dgrad and wgrad kernels
  and time them beside cuDNN at R(2+1)D layer1's shape (all three bf16
  kernels there on their wgmma routes; the per-route counts show it).
Then it times the SK kernel and the train step. Every phase raises on
failure, so any failure exits non-zero. Standard output ends with a line
``{"kernels": [...]}`` and then the result line ``{"ok": true, "device":
{...}}``; logs go to standard error.

Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import logging
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Main path: the reference VGG-Sound recipe at full width (R(2+1)D-18 with
# parity midplanes, ResNet-9 audio, 10 heads, K=309, 30x112x112 video,
# 257x99 spectrograms, batch 24, bf16). Cut to size: 480 synthetic samples
# (one epoch of 20 steps), one SK step at iteration 0, 2 BN-warmup batches.
MAIN_ARGS = (
    "--ds_name synthetic --num_data_samples 480 --batch_size 24 "
    "--headcount 10 --mlp_dim 309 --num_frames 30 --train_crop_size 112 "
    "--aud_spec_type 2 --aud_sample_rate 48000 --epochs 1 --nopts 1 "
    "--match true --compute_dtype bfloat16 --bn_warmup_batches 2 "
    "--workers 8 --base_lr 0.01 --wd 0.00001 --seed 31"
)
PAPER_N, PAPER_K = 170752, 309  # VGG-Sound SK scale
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
# slice (Co = 64: the weights fit); and two output-channel blocks of the
# forward (Co = 136), whose dgrad weights do not fit.
CONV_RAGGED_SHAPES = {
    (2, 9, 13, 3, 136): ("wmma", "wmma", "wmma"),
    (3, 7, 11, 72, 136): ("wmma", "wmma", "wgmma"),
    (2, 3, 70, 16, 24): ("wgmma", "wgmma", "wgmma"),
    (1, 1, 1, 8, 8): ("wgmma", "wgmma", "wgmma"),
    (5, 3, 3, 64, 128): ("wgmma", "wgmma", "wgmma"),
    (2, 3, 130, 64, 128): ("wgmma", "wgmma", "wgmma"),
    (2, 5, 7, 72, 64): ("wgmma", "wgmma", "wgmma"),
    (1, 6, 10, 16, 136): ("wgmma", "wmma", "wgmma"),
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
    """Phase 2a: the kernel against its plain version on the card."""
    worst = 0.0
    inputs = {}
    for n, k in ((300, 37), (480, 309), (PAPER_N, PAPER_K)):
        log_ps, log_r = sk_instance(torch, n, k, seed=n, device=device)
        m32 = (10.0 * log_ps).contiguous()
        log_beta = torch.full((n,), -math.log(n), device=device)
        log_alpha = log_r - torch.logsumexp(m32 + log_beta[:, None], 0)
        for m in (m32, m32.to(torch.bfloat16)):
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
    report["max_abs_err"] = worst
    return inputs


def solver_fused_vs_plain(torch, device, report):
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = sinkhorn_knopp(log_ps, log_r, backend="fused")
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
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


def main_path(torch, sf, device, report):
    """Phase 3: the Trainer at full width; the kernel count must move."""
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.synthetic import SyntheticAVDataset
    from selavi_tpu_torch.train.loop import Trainer

    args = parse_arguments().parse_args(MAIN_ARGS.split())
    dataset = SyntheticAVDataset(
        num_samples=args.num_data_samples,
        num_classes=max(args.mlp_dim // 4, 2),
        num_frames=args.num_frames, crop_size=args.train_crop_size,
        num_sec=args.num_sec_aud, aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type, seed=args.seed,
    )
    trainer = Trainer(args, dataset)  # the card: no device argument
    sf.reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sf.launches
    report["launches"] = launches

    sk = [h for h in history if "sk_cost" in h]
    losses = [h["loss"] for h in history if "iter" in h]
    final = [h["loss"] for h in history if "iter" not in h and "loss" in h]
    print(f"main path: fit() {wall:.1f} s, {trainer.batches_per_epoch} "
          f"steps of {args.batch_size}, SK steps {len(sk)}, first loss "
          f"{losses[0]:.4f} (ln {args.mlp_dim} = {math.log(args.mlp_dim):.4f})"
          f", last loss {final[-1]:.4f}, SK {sk[0] if sk else None}, "
          f"fused SK launches {launches}", flush=True)
    check(len(sk) == 1, "one SK step")
    check(math.isfinite(sk[0]["sk_cost"]), "SK cost finite")
    check(sk[0]["sk_iters_max"] < 2000, "SK iters < 2000")
    check(all(math.isfinite(x) for x in losses + final), "losses finite")
    check(abs(losses[0] - math.log(args.mlp_dim)) < 0.5, "first loss ~ ln K")
    labels = trainer.selflabels
    check(labels.shape == (len(dataset), args.headcount), "label shape")
    check(all(len(set(labels[:, h].tolist())) > 1
              for h in range(args.headcount)), "every head uses >1 cluster")
    check(launches > 0, "the main path launched the fused SK kernel")
    return trainer


def time_train(torch, trainer, report):
    """Phase 4b: train clips/s, device-resident batch and full epoch."""
    batch = next(iter(trainer.loader))
    labels = torch.zeros(batch["index"].shape[0], trainer.args.headcount,
                         dtype=torch.long, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    for _ in range(3):
        trainer.train_step(batch, labels, gen)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch, labels, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    clips = batch["video"].shape[0]
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    n_epoch = trainer.batches_per_epoch * clips
    report["train_clips_per_s"] = clips / step_s
    report["epoch_clips_per_s"] = n_epoch / epoch_s
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9


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


def conv_probe_path(torch, conv, device, report):
    """Phase 5: the conv probe's entry point (check, then bench); every
    conv kernel count must move, and the bench shape's bf16 forward, dgrad
    and weight gradient must go through their wgmma kernels."""
    from selavi_tpu_torch.experiments import conv3x3 as probe

    conv.reset_launches()
    probe.check(device)
    bench = probe.bench(device)
    torch.cuda.synchronize()
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

    report: dict = {}
    inputs = kernel_vs_plain(torch, sf, device, report)
    solver_fused_vs_plain(torch, device, report)
    conv_kernels_vs_plain(torch, conv, device, report)
    trainer = main_path(torch, sf, device, report)
    conv_probe_path(torch, conv, device, report)

    # Phase 4a: the SK kernel at paper scale, against its byte bound.
    bw = measure.memory_bandwidth(device)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs[(PAPER_N, PAPER_K, dtype)]
        m = args[0]
        nbytes = (m.numel() * m.element_size() + 2 * 4 * PAPER_N
                  + 3 * 4 * PAPER_K + 4)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = OPS_PER_ELEMENT * m.numel() / measure.FP32_PEAK_FLOPS * 1e3
        times[dtype] = {
            "ms": measure.cuda_ms(lambda: sf.fused_sk_iteration(*args)),
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
    print(f"SK solver {PAPER_N}x{PAPER_K} fp32 fused on {card}: "
          f"{report['solver_it_per_s']:.1f} it/s", flush=True)

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
