"""Eval-mode BatchNorm, residual add and ReLU on the card: the kernel of
``ops/bn_act.py`` at every BatchNorm of the SK step's towers.

    python -m selavi_tpu_torch.experiments.bn_act [--bench]

It runs ``train/step.py::encode``, the SK step's eval forward (full-width
R(2+1)D-18 and ResNet-9 under bf16 autocast, 30x112x112 clips and 1 s of
24 kHz PCM made 257x99 log-mel on the card), on a batch of 2 and prints
every BatchNorm call (``bn_calls``): its module, input shape, dtype and
layout, whether it adds a residual and applies ReLU, and whether the
kernel took it.

``--bench`` runs each call's shape at batch 128 (the benchmark's
``sk_agg_batch``), x in bf16 in the call's layout and a residual where
the call has one: the kernel timed (CUDA events) beside its byte bound (x,
the residual and y once in bf16 at 3.35 TB/s) and the ATen composition the
towers ran before (``bn_act_plain`` on the card: ``F.batch_norm``, the add,
``F.relu``; ``library_ms``), each with the host's microseconds to enqueue
a call, and held to it within one bf16 ulp (``bf16_ulps``). It prints one
JSON line of them and exits 1 if a shape is off by more than one ulp. It
needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.models.common import BN_EPS, FlaxBatchNorm
from selavi_tpu_torch.ops import bn_act as ba

# NVIDIA H100 SXM data sheet: HBM3.
HBM_BYTES_PER_S = 3.35e12
# The SK step's audio: 1 s of 24 kHz PCM, 257 filters (the vggsound cell).
AUDIO_CFG = {"samplerate": 24000, "nfilt": 257, "z_normalize": False}
# How far the kernel may lie from the ATen composition: in bf16 ulps
# (``bf16_ulps``), in fp32 in 2^-23 of the terms' magnitude
# (``fp32_ulps``). Both sums take a few fp32 roundings of terms as large
# as ``term_scale``: kernel and composition lie up to 2.7 apart on the CPU.
TOLERANCE = {torch.bfloat16: 1.0, torch.float32: 8.0}


def bf16_ulps(y: torch.Tensor, ref: torch.Tensor, *terms) -> float:
    """max |y - ref| in bf16 ulps of the largest magnitude among y, ref
    and ``terms`` at each element (pass the BatchNorm's own output where a
    residual was added to it), with a floor of 2^-8 of ref's largest
    magnitude. The kernel rounds the sum once, the composition after the
    BatchNorm and again after the add: where the sum cancels, the first
    rounding's error is an ulp of the BatchNorm term, not of the sum."""
    y, ref = y.float(), ref.float()
    mag = torch.maximum(y.abs(), ref.abs())
    for t in terms:
        mag = torch.maximum(mag, t.float().abs())
    mag = torch.maximum(mag, ref.abs().max() * 2.0 ** -8)
    return float(((y - ref).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def term_scale(x, res, params) -> torch.Tensor:
    """``(|x| + |mean|) |s| + |bias| (+ |r|)`` at each element in fp32,
    ``s = weight / sqrt(var + eps)``: the magnitude of the terms that
    both the kernel's ``x * s + t (+ r)`` and ATen's ``(x - mean) * invstd
    * weight + bias (+ r)`` add up, which their roundings scale with."""
    w, b, m, v = params
    shape = [1, -1] + [1] * (x.dim() - 2)
    s = (w / torch.sqrt(v + BN_EPS)).abs().view(shape)
    scale = (x.float().abs() + m.abs().view(shape)) * s + b.abs().view(shape)
    return scale if res is None else scale + res.float().abs()


def fp32_ulps(y: torch.Tensor, ref: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max |y - ref| over 2^-23 of ``scale`` (``term_scale``) at each
    element: fp32 ulps of the terms, not of the result, which cancels."""
    err = (y.float() - ref.float()).abs()
    return float((err / (scale.clamp_min(2.0 ** -126) * 2.0 ** -23)).max())


def layout(x: torch.Tensor) -> str:
    return ba.layout(x) or f"strides {tuple(x.stride())}"


def bn_calls(device, batch: int = 2) -> list:
    """Every FlaxBatchNorm call of one SK-step encode of the full-width
    towers, in order: ``{"name", "shape" (C, ...) without the batch,
    "dtype", "layout", "relu", "residual", "kernel"}``."""
    from selavi_tpu_torch.models.av_model import load_model
    from selavi_tpu_torch.train.step import encode

    model = load_model(headcount=10, num_classes=309, seed=0, device=device)
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, FlaxBatchNorm):
            def hook(mod, args, kwargs, name=name):
                x = args[0]
                res = kwargs.get("residual")
                params = (mod.weight, mod.bias, mod.running_mean,
                          mod.running_var)
                calls.append({
                    "name": name, "shape": list(x.shape[1:]),
                    "dtype": str(x.dtype)[6:], "layout": layout(x),
                    "relu": bool(kwargs.get("relu", False)),
                    "residual": res is not None,
                    "kernel": ba.kernel_takes(x, params, res)})
            hooks.append(mod.register_forward_pre_hook(hook,
                                                       with_kwargs=True))
    gen = torch.Generator(device=device).manual_seed(0)
    clips = torch.randint(0, 256, (batch, 30, 112, 112, 3),
                          dtype=torch.uint8, device=device, generator=gen)
    pcm = torch.randn(batch, 24000, device=device, generator=gen)
    encode(model, clips, pcm, gen, compute_dtype=torch.bfloat16,
           audio_cfg=AUDIO_CFG)
    for h in hooks:
        h.remove()
    return calls


def inputs(call, batch, device, gen, dtype=torch.bfloat16):
    """x (contiguous where the call's ``layout`` is planar, else channels
    fastest), the residual where the call has one, and parameters of the
    call's width: running variances in [0.5, 1.5]."""
    c = call["shape"][0]
    fmt = (torch.contiguous_format if call.get("layout") == "planar"
           else ba.FORMATS[len(call["shape"]) + 1])
    shape = (batch, *call["shape"])

    def draw():
        return torch.randn(shape, device=device, generator=gen,
                           dtype=dtype).contiguous(memory_format=fmt)

    x = draw()
    res = draw() if call["residual"] else None
    params = (1 + 0.2 * torch.randn(c, device=device, generator=gen),
              0.2 * torch.randn(c, device=device, generator=gen),
              0.2 * torch.randn(c, device=device, generator=gen),
              0.5 + torch.rand(c, device=device, generator=gen))
    return x, res, params


def chunked_ulps(x, res, params, relu, y, ref, chunk=16) -> float:
    """How far y lies from ref in x's dtype's measure, over batch chunks
    in bounded memory: ``bf16_ulps`` (the BatchNorm term beside a
    residual) for bf16, ``fp32_ulps`` for fp32; held to ``TOLERANCE``."""
    worst = 0.0
    for s in range(0, x.shape[0], chunk):
        sl = slice(s, s + chunk)
        r = None if res is None else res[sl]
        if x.dtype == torch.float32:
            far = fp32_ulps(y[sl], ref[sl], term_scale(x[sl], r, params))
        else:
            terms = ()
            if r is not None:
                w, b, m, v = params
                terms = (F.batch_norm(x[sl], m, v, w, b, training=False,
                                      eps=BN_EPS),)
            far = bf16_ulps(y[sl], ref[sl], *terms)
        worst = max(worst, far)
    return worst


def host_us(fn, reps: int = 20) -> float:
    """Microseconds of host time to enqueue one call of ``fn`` on an idle
    card (the launches' queue is far from full)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def bench(device, batch: int = 128, calls=None) -> list:
    """The kernel at each BatchNorm call's shape (``bn_calls`` when
    ``calls`` is None) at ``batch``, against its bound and the ATen
    composition, and held to it (``ulps``, ``max_abs_err``)."""
    calls = bn_calls(device) if calls is None else calls
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for call in calls:
        x, res, params = inputs(call, batch, device, gen)
        relu = call["relu"]
        nbytes = x.numel() * x.element_size() * (3 if res is not None else 2)

        def kernel():
            return ba.bn_act(x, *params, BN_EPS, relu, res)

        def library():
            return ba.bn_act_plain(x, *params, BN_EPS, relu, res)

        row = {"name": call["name"], "input": list(x.shape),
               "relu": relu, "residual": res is not None,
               "model_takes_kernel": call["kernel"], "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "ms": cuda_ms(kernel, reps=20),
               "library_ms": cuda_ms(library, reps=20),
               "host_us": host_us(kernel),
               "library_host_us": host_us(library)}
        y, ref = kernel(), library()
        row["ulps"] = chunked_ulps(x, res, params, relu, y, ref)
        row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
        row["repeat_equal"] = bool(torch.equal(y, kernel()))
        row["strides_kept"] = y.stride() == x.stride()
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"{call['name']} {row['input']} relu {relu} residual "
              f"{row['residual']}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB), "
              f"{row['bound_share'] * 100:.1f}% of bound; ATen composition "
              f"{row['library_ms']:.4f} ms; vs it {row['ulps']:.2f} bf16 "
              f"ulps, repeat equal {row['repeat_equal']}; host "
              f"{row['host_us']:.1f} us a call (ATen "
              f"{row['library_host_us']:.1f})", flush=True)
        rows.append(row)
        del x, res, y, ref
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "library_ms", "bound_ms", "bytes", "host_us",
                       "library_host_us")}
    print(f"all {len(rows)}: kernel {total['ms']:.3f} ms, bound "
          f"{total['bound_ms']:.3f} ms ({total['bytes'] / 1e9:.2f} GB), ATen "
          f"composition {total['library_ms']:.3f} ms; host "
          f"{total['host_us'] / 1e3:.2f} ms (ATen "
          f"{total['library_host_us'] / 1e3:.2f} ms)", flush=True)
    print(json.dumps({"bn_act_bench": rows, "total": total}), flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bench", action="store_true",
                        help="time the kernel at every call's shape at "
                             "batch 128 as well")
    args = parser.parse_args()
    device = resolve_device()
    print(f"card: {card_description()}", flush=True)
    calls = bn_calls(device)
    for call in calls:
        print(f"{call['name']}: {call['shape']} {call['dtype']} "
              f"{call['layout']}, relu {call['relu']}, residual "
              f"{call['residual']}, kernel {call['kernel']}", flush=True)
    print(f"{len(calls)} BatchNorm calls, {sum(c['kernel'] for c in calls)} "
          f"on the kernel", flush=True)
    if args.bench:
        rows = bench(device, calls=calls)
        far = [r["name"] for r in rows if r["ulps"] > 1.0]
        if far:
            print(f"more than one bf16 ulp from the ATen composition: {far}",
                  flush=True)
            sys.exit(1)


if __name__ == "__main__":
    main()
