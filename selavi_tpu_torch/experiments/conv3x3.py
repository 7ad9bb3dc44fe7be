"""The 3x3 conv probe: the port's counterpart of
``experiments/pallas_conv3x3.py`` and its ``--check`` / ``--bench``.

    python -m selavi_tpu_torch.experiments.conv3x3 --check --bench
    python -m selavi_tpu_torch.experiments.conv3x3 --check --device cpu

``--check`` runs the probe's two shapes in fp32 and holds the forward,
dgrad and wgrad of ``ops/conv3x3.py`` against ``torch.autograd.grad`` of
the plain forward (as the JAX probe holds its kernels against ``jax.vjp``
of XLA's conv), and against cuDNN's ``F.conv2d`` and its backward (plain
torch ops on the CPU), with TF32 off.

``--bench`` times, on the card, at R(2+1)D layer1's hot shape
``[480, 56, 56, 64] -> 128`` in bf16 and fp32: the three kernels, their
plain versions, and as yardsticks cuDNN's forward (``F.conv2d`` on the
channels-last view), cuDNN's data and weight gradients (one
``aten.convolution_backward`` call each), and cuDNN's forward plus backward
together. It prints each time with its
TFLOP/s and bound and the card's name and power limit. With no card it
raises.

Both run on the card unless ``--device cpu`` is given; with no card and no
explicit request they raise.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.measure import (
    BF16_TENSOR_PEAK_FLOPS,
    FP32_PEAK_FLOPS,
    card_description,
    cuda_ms,
    memory_bandwidth,
)
from selavi_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_plain,
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
)

CHECK_SHAPES = ((2, 28, 56, 64, 128), (1, 8, 16, 8, 16))  # N, H, W, C, Co
BENCH_SHAPE = (480, 56, 56, 64, 128)
# fp32 against autograd of the plain forward: the same sums in another
# order, so within a few fp32 roundings of the largest value.
CHECK_RTOL = 1e-5
# fp32 against cuDNN (TF32 off): its algorithms may transform the operands
# (Winograd, FFT) and round otherwise than a direct sum; its weight
# gradient differed from both direct sums by 8e-6 at the first check shape
# on an H100.
LIBRARY_RTOL = 1e-4
KERNELS = ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad")


@contextlib.contextmanager
def tf32_off():
    """Full fp32 in matmuls and cuDNN convolutions (cuDNN's default is
    TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _nchw(t):
    """NHWC -> the NCHW view of the same memory (channels last)."""
    return t.permute(0, 3, 1, 2)


def _oihw(w):
    """HWIO [3, 3, C, Co] -> OIHW [Co, C, 3, 3], channels last."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_conv3x3(x, w):
    return F.conv2d(_nchw(x), _oihw(w), padding=1).permute(0, 2, 3, 1)


def _convolution_backward(g, x, w, mask):
    """cuDNN's backward of the conv in one call, on the channels-last views
    of NHWC g and x and HWIO w (``torch.nn.grad``'s helpers pass zero-stride
    stand-ins, which steer cuDNN off the channels-last kernels)."""
    return torch.ops.aten.convolution_backward(
        _nchw(g), _nchw(x), _oihw(w), None, (1, 1), (1, 1), (1, 1), False,
        (0, 0), 1, mask)


def library_dgrad(g, w):
    n, h, wd, _ = g.shape
    x = torch.empty((n, h, wd, w.shape[2]), dtype=g.dtype, device=g.device)
    dx = _convolution_backward(g, x, w, (True, False, False))[0]
    return dx.permute(0, 2, 3, 1)


def library_wgrad(x, g):
    w = torch.empty((3, 3, x.shape[3], g.shape[3]), dtype=x.dtype,
                    device=x.device)
    dw = _convolution_backward(g, x, w, (False, True, False))[1]
    return dw.permute(2, 3, 1, 0)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|, in fp32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / (ref.abs().max() + 1e-6))


def check(device=None) -> None:
    """The probe's check shapes in fp32; raises on a disagreement."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    with tf32_off():
        for shape in CHECK_SHAPES:
            n, h, wd, ci, co = shape

            def draw(size, sd):
                return torch.from_numpy(
                    rng.normal(0, sd, size).astype(np.float32)).to(device)

            x = draw((n, h, wd, ci), 1.0)
            w = draw((3, 3, ci, co), 0.1)
            g = draw((n, h, wd, co), 1.0)
            xr = x.clone().requires_grad_()
            wr = w.clone().requires_grad_()
            ref = conv3x3_plain(xr, wr)
            dx_ref, dw_ref = torch.autograd.grad(ref, (xr, wr), g)
            cases = (
                ("conv3x3", conv3x3(x, w), ref.detach(),
                 library_conv3x3(x, w)),
                ("conv3x3_dgrad", conv3x3_dgrad(g, w), dx_ref,
                 library_dgrad(g, w)),
                ("conv3x3_wgrad", conv3x3_wgrad(x, g), dw_ref,
                 library_wgrad(x, g)),
            )
            for name, got, vjp_ref, lib_ref in cases:
                e_vjp, e_lib = rel_err(got, vjp_ref), rel_err(got, lib_ref)
                print(f"check {shape} {name}: rel err {e_vjp:.2e} vs "
                      f"autograd of the plain forward, {e_lib:.2e} vs "
                      f"torch conv ({device.type})", flush=True)
                if e_vjp > CHECK_RTOL or e_lib > LIBRARY_RTOL:
                    raise RuntimeError(
                        f"{name} at {shape}: rel err {e_vjp:.3g} (limit "
                        f"{CHECK_RTOL}) vs autograd, {e_lib:.3g} (limit "
                        f"{LIBRARY_RTOL}) vs torch conv")
    print("CHECK OK", flush=True)


def bound(name: str, shape, dtype, bandwidth: float) -> dict:
    """The least time the card could take for ``name`` at ``shape``: the
    larger of the bytes it must move (each input read once, each output
    written once) over ``bandwidth`` (bytes/s), and its FLOP over the peak
    rate of ``dtype`` (bf16 tensor cores, or fp32 CUDA cores)."""
    n, h, wd, c, co = shape
    pixels = n * h * wd
    size = torch.empty((), dtype=dtype).element_size()
    flops = 2 * pixels * 9 * c * co
    if name == "conv3x3_wgrad":
        nbytes = pixels * (c + co) * size + 9 * c * co * 4
    else:
        nbytes = (pixels * (c + co) + 9 * c * co) * size
    peak = BF16_TENSOR_PEAK_FLOPS if dtype == torch.bfloat16 else \
        FP32_PEAK_FLOPS
    bytes_ms = nbytes / bandwidth * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": nbytes}


def bench(device=None, reps: int = 20) -> dict:
    """Times at BENCH_SHAPE on the card. Returns {(kernel, dtype name):
    {ms, plain_ms, library_ms, bound_ms, bound_by, flops, bytes}} plus
    {("cudnn_fwd_bwd", dtype name): {ms}}."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench times the card: it needs a CUDA device")
    card = card_description()
    bandwidth = memory_bandwidth(device)
    n, h, wd, ci, co = BENCH_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    with tf32_off():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            x = torch.randn(n, h, wd, ci, generator=gen, device=device)
            w = 0.1 * torch.randn(3, 3, ci, co, generator=gen, device=device)
            g = torch.randn(n, h, wd, co, generator=gen, device=device)
            x, w, g = x.to(dtype), w.to(dtype), g.to(dtype)
            fns = {
                "conv3x3": (lambda: conv3x3(x, w),
                            lambda: conv3x3_plain(x, w),
                            lambda: library_conv3x3(x, w)),
                "conv3x3_dgrad": (lambda: conv3x3_dgrad(g, w),
                                  lambda: conv3x3_dgrad_plain(g, w),
                                  lambda: library_dgrad(g, w)),
                "conv3x3_wgrad": (lambda: conv3x3_wgrad(x, g),
                                  lambda: conv3x3_wgrad_plain(x, g),
                                  lambda: library_wgrad(x, g)),
            }
            for name, (kernel, plain, library) in fns.items():
                t = bound(name, BENCH_SHAPE, dtype, bandwidth)
                t["ms"] = cuda_ms(kernel, reps=reps)
                t["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
                t["library_ms"] = cuda_ms(library, reps=reps)
                results[(name, dname)] = t
                print(f"bench {name} {BENCH_SHAPE} {dname} on {card}: "
                      f"kernel {t['ms']:.4f} ms "
                      f"({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
                      f"{t['bound_ms'] / t['ms'] * 100:.1f}% of the "
                      f"{t['bound_ms']:.4f} ms bound by {t['bound_by']}), "
                      f"plain {t['plain_ms']:.4f} ms, torch/cuDNN "
                      f"{t['library_ms']:.4f} ms", flush=True)

            xg = _nchw(x).requires_grad_()
            wg = _oihw(w).requires_grad_()

            def fwd_bwd():
                y = F.conv2d(xg, wg, padding=1)
                return torch.autograd.grad(y, (xg, wg), _nchw(g))

            ms = cuda_ms(fwd_bwd, reps=reps)
            results[("cudnn_fwd_bwd", dname)] = {"ms": ms}
            flops3 = 3 * results[("conv3x3", dname)]["flops"]
            print(f"bench cuDNN forward + backward {BENCH_SHAPE} {dname} on "
                  f"{card}: {ms:.4f} ms ({flops3 / ms / 1e9:.1f} TFLOP/s)",
                  flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true",
                   help="hold the kernels against references at the "
                        "probe's check shapes (fp32)")
    p.add_argument("--bench", action="store_true",
                   help="time the kernels and cuDNN at the bench shape "
                        "(needs a card)")
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device; default: the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.check:
        check(device)
    if args.bench:
        bench(device)


if __name__ == "__main__":
    main()
