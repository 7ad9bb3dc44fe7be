"""R(2+1)D's temporal (3,1,1) convolutions on the card: the hand kernel
(``ops/temporal_conv.py``) beside the cuDNN calls it replaced.

    python -m selavi_tpu_torch.experiments.temporal_conv [--bench]

The traced train step found cuDNN running these convs, on the bf16
channels_last_3d inputs that autocast hands them, as an fp32 FFMA kernel
(``..._fprop_implicit_gemm_indexed_f32f32_...``) between layout copies.
This captures the stem's and layer1's temporal conv inputs as the model
hands them over (a forward of the full-width model under bf16 autocast,
batch 24, 30x112x112), prints their dtype and memory layout, and then runs
each conv alone: the hand kernel, and cuDNN under bf16 autocast as the
model called it before, on inputs cast to bf16 by hand in NCDHW and in
channels_last_3d, each with ``cudnn.benchmark`` off and on. For each it
prints the kernels that the profiler saw and the ms per call (CUDA events).

``--bench`` times the kernel at the tower's 17 temporal conv shapes at
batch 128 (parity midplanes, 30x112x112 clips) against its bound (the
larger of its bytes, x read once and y written once in bf16, at 3.35 TB/s
and its operations at 989 TFLOP/s) and cuDNN as the model called it before
(``F.conv3d`` under bf16 autocast, fp32 weights); at the stem's, layer1's
and layer4-block1's shapes also the plain version; and prints one JSON line
of them. At every shape it holds the kernel's output to the plain
version's within one bf16 ulp (``bf16_ulps``) and exits 1 if one is not.
It needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.r2plus1d import temporal_conv_shapes
from selavi_tpu_torch.ops import temporal_conv as tc
from selavi_tpu_torch.ops.preprocess import normalize_video

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, HBM3.
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the kernel table's shapes
TABLE = ("stem_temporal", "layer1_block0.conv1.temporal",
         "layer4_block1.conv1.temporal")


def layout(x: torch.Tensor) -> str:
    if x.is_contiguous():
        return "NCDHW"
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    return f"strides {tuple(x.stride())}"


def captured_inputs(device, batch: int = 24):
    """{name: (input, conv module)} of the stem's and layer1's temporal
    convs, from one forward of the full-width towers under bf16
    autocast."""
    model = load_model(headcount=10, num_classes=309, seed=0, device=device)
    model.train()
    video = model.video_network
    convs = {"stem temporal": video.stem_temporal,
             "layer1 temporal": video.layer1_block0.conv1.temporal}
    got = {}
    for name, conv in convs.items():
        conv.register_forward_pre_hook(
            lambda mod, inp, name=name: got.setdefault(name, inp[0].detach()))
    gen = torch.Generator(device=device).manual_seed(0)
    clips = torch.randint(0, 256, (batch, 30, 112, 112, 3),
                          dtype=torch.uint8, device=device, generator=gen)
    audio = torch.randn(batch, 257, 99, 1, device=device, generator=gen)
    with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16):
        model(normalize_video(clips), audio, return_features=True)
    return {name: (got[name], conv) for name, conv in convs.items()}


def kernels_of(fn) -> list:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def autocast_conv(x, w, stride):
    """The conv as the model called it before: ``F.conv3d`` under bf16
    autocast on the fp32 weight."""
    with torch.autocast("cuda", dtype=torch.bfloat16):
        return F.conv3d(x, w, None, (stride, 1, 1), tc.PADDING)


def variants_main(device) -> None:
    for name, (x, conv) in captured_inputs(device).items():
        w = conv.weight.detach()
        stride = conv.stride[0]
        print(f"{name}: input {list(x.shape)} {str(x.dtype)[6:]} "
              f"{layout(x)}, weight {list(w.shape)} {str(w.dtype)[6:]}",
              flush=True)
        kw = dict(stride=conv.stride, padding=conv.padding)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        xcl = xb.contiguous(memory_format=torch.channels_last_3d)
        wcl = wb.contiguous(memory_format=torch.channels_last_3d)
        variants = {
            "hand kernel (ops/temporal_conv.py)":
                lambda: tc.temporal_conv(xcl, wb, stride),
            "autocast, as the model called it before":
                lambda: autocast_conv(x, w, stride),
            "bf16 NCDHW": lambda: F.conv3d(xb.contiguous(), wb, **kw),
            "bf16 channels_last_3d": lambda: F.conv3d(xcl, wcl, **kw),
        }
        for benchmark in (False, True):
            torch.backends.cudnn.benchmark = benchmark
            for label, fn in variants.items():
                ms = cuda_ms(fn, reps=20)
                print(f"  {label}, cudnn.benchmark {benchmark}: {ms:.4f} ms; "
                      f"output {str(fn().dtype)[6:]}; kernels "
                      f"{[k[:100] for k in kernels_of(fn)]}", flush=True)
        torch.backends.cudnn.benchmark = False


def bf16_ulps(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| in bf16 ulps of the larger magnitude of the two, with
    a floor of 2^-8 of ref's largest magnitude for sums that cancel to
    near zero. The kernel and the plain version sum the same fp32 products
    in another order and round once: at most one ulp apart."""
    y, ref = y.float(), ref.float()
    mag = torch.maximum(torch.maximum(y.abs(), ref.abs()),
                        ref.abs().max() * 2.0 ** -8)
    return float(((y - ref).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def bound_of(batch, c, co, stride, t, h, w) -> dict:
    pixels = h * w
    t_out = tc.out_frames(t, stride)
    nbytes = 2 * batch * pixels * (t * c + t_out * co)
    flops = 2 * batch * t_out * pixels * co * 3 * c
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_PEAK_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def bench(device, batch: int = 128, names=None) -> list:
    """The kernel at the tower's 17 shapes (parity, 30x112x112), or at
    those in ``names``, against its bound and cuDNN as the model called it,
    and held to the plain version (``ulps``, ``max_abs_err``); the plain
    version timed at TABLE's."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for name, c, co, stride, t, h, w in temporal_conv_shapes("parity"):
        if names is not None and name not in names:
            continue
        x = torch.randn(batch, c, t, h, w, device=device, generator=gen,
                        dtype=torch.bfloat16).contiguous(
                            memory_format=torch.channels_last_3d)
        wt = torch.randn(co, c, 3, 1, 1, device=device, generator=gen)
        wt = wt * c ** -0.5
        wb = wt.to(torch.bfloat16)
        plan = tc.plan(c, co, h * w)
        row = {"name": name, "c": c, "co": co, "stride": stride,
               "input": [batch, c, t, h, w], **bound_of(batch, c, co, stride,
                                                          t, h, w),
               "plan": plan,
               "ms": cuda_ms(lambda: tc.temporal_conv(x, wb, stride),
                             reps=20),
               "library_ms": cuda_ms(lambda: autocast_conv(x, wt, stride),
                                     reps=20)}
        y, ref = (tc.temporal_conv(x, wb, stride),
                  tc.temporal_conv_plain(x, wb, stride))
        row["ulps"] = bf16_ulps(y, ref)
        row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
        del y, ref
        row["plain_ms"] = (cuda_ms(lambda: tc.temporal_conv_plain(
            x, wb, stride), reps=3, warmup=1) if name in TABLE else None)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"{name} {row['input']} -> {co}, stride {stride}: kernel "
              f"{row['ms']:.4f} ms ({'resident' if plan['resident'] else 'streamed'}, "
              f"{plan['load']}, {plan['stages']} stages), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bytes'] / 1e9:.3f} GB), {row['bound_share'] * 100:.1f}% "
              f"of bound; cuDNN as called before {row['library_ms']:.4f} ms"
              + (f"; plain {row['plain_ms']:.4f} ms"
                 if row["plain_ms"] is not None else "")
              + f"; vs plain {row['ulps']:.2f} bf16 ulps", flush=True)
        rows.append(row)
        del x
        torch.cuda.empty_cache()
    if names is not None:
        return rows
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "library_ms", "bound_ms", "bytes")}
    first5 = {k: sum(r[k] for r in rows[:5])
              for k in ("ms", "library_ms", "bound_ms", "bytes")}
    print(f"all 17: kernel {total['ms']:.3f} ms, bound {total['bound_ms']:.3f}"
          f" ms, cuDNN {total['library_ms']:.3f} ms; stem + layer1: kernel "
          f"{first5['ms']:.3f} ms, bound {first5['bound_ms']:.3f} ms "
          f"({first5['bytes'] / 1e9:.2f} GB), cuDNN "
          f"{first5['library_ms']:.3f} ms", flush=True)
    print(json.dumps({"temporal_conv_bench": rows, "total": total,
                      "stem_layer1": first5}), flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bench", action="store_true",
                        help="time the kernel at the tower's 17 shapes at "
                             "batch 128 instead")
    args = parser.parse_args()
    device = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_description()}", flush=True)
    if args.bench:
        rows = bench(device)
        far = [r["name"] for r in rows if r["ulps"] > 1.0]
        if far:
            print(f"more than one bf16 ulp from the plain version: {far}",
                  flush=True)
            sys.exit(1)
    else:
        variants_main(device)


if __name__ == "__main__":
    main()
