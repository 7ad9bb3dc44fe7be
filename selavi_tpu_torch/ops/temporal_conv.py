"""Temporal (3,1,1) convolution of R(2+1)D: the Hopper kernel, its plain
version and the autograd Function around them.

    temporal_conv(x, w, stride) -> y

x ``[B, C, T, H, W]``, w ``[Co, C, 3, 1, 1]``, stride 1 or 2 in T, padding
(1, 0, 0): ``y[b, o, t] = sum_{k, c} w[o, c, k] x[b, c, stride t + k - 1]``,
zero outside ``[0, T)``, ``[B, Co, T_out, H, W]`` in x's dtype with
``T_out = (T - 1) // stride + 1``.

``temporal_conv`` launches the CUDA kernel (``csrc/temporal_conv.cu``, see
there for its design and bound) for bf16 CUDA tensors, x in
channels_last_3d memory; y comes back channels_last_3d. On any other CUDA
input it raises (``check_kernel_args``): there is no fallback. It runs
``temporal_conv_plain`` for CPU tensors. ``TemporalConvFunction`` is its
autograd Function: the backward is ``aten.convolution_backward`` with the
arguments autograd gives a conv3d, so the same library dgrad and wgrad
kernels run as before. The kernel library is compiled with ``nvcc`` at the
first launch (see ``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from selavi_tpu_torch.ops import _build
from selavi_tpu_torch.utils import profiling

SOURCE = _build.CSRC / "temporal_conv.cu"
STRIDES = (1, 2)
PADDING = (1, 0, 0)

# Kernel launches made through temporal_conv (plain calls not counted).
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def build_library() -> Path:
    """Compile ``csrc/temporal_conv.cu`` (see ``ops/_build.py``) and return
    the library's path."""
    return _build.build_library(SOURCE)


def load_library(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/temporal_conv.cu`` and declare its C
    functions."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.temporal_conv_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.temporal_conv_fwd.restype = i32
    lib.temporal_conv_plan.argtypes = [i32, i32, i32, ctypes.c_longlong,
                                       ctypes.POINTER(ctypes.c_longlong)]
    lib.temporal_conv_plan.restype = None
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load_library(build_library())
    return _lib


LOADS = ("tma", "cp.async", "staged")


def plan(c: int, co: int, hw: int, x_address: int = 0) -> dict:
    """The kernel's parameters for C -> Co channels, planes of ``hw``
    pixels and x at ``x_address`` (0: any 16-byte aligned address), from
    the library: dynamic shared memory, whether the weights stay resident
    beside a ring of whole frames, the ring's depth, BN, how the A tiles
    land (``LOADS``), the bytes of a cp.async copy, and whether a staged
    tile lands by one bulk copy."""
    out = (ctypes.c_longlong * 7)()
    _library().temporal_conv_plan(c, co, hw, x_address, out)
    smem, resident, stages, bn, load, gran, flat = out
    return {"smem": smem, "resident": bool(resident), "stages": stages,
            "bn": bn, "load": LOADS[load], "gran": gran, "flat": bool(flat)}


def out_frames(t: int, stride: int) -> int:
    return (t - 1) // stride + 1


# ---------------------------------------------------------------- plain


def temporal_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """The kernel's arithmetic spelled out: three shifted frame windows of
    the zero-padded x, each a matmul over channels with one tap of w, in
    fp32 (fp64 for fp64 inputs), summed in that precision and rounded once
    to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    t_out = out_frames(x.shape[2], stride)
    xp = F.pad(x.to(acc), (0, 0, 0, 0, 1, 1))
    y = None
    for k in range(3):
        window = xp[:, :, k:k + stride * (t_out - 1) + 1:stride]
        part = torch.einsum("bcthw,oc->bothw", window,
                            w[:, :, k, 0, 0].to(x.dtype).to(acc))
        y = part if y is None else y + part
    return y.to(x.dtype)


# ---------------------------------------------------------------- kernel


def check_kernel_args(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    """Raises on what the kernel does not take: anything but x [B, C, T, H,
    W] bf16 in channels_last_3d memory, w [Co, C, 3, 1, 1] bf16 with Co a
    multiple of 8, stride 1 or 2, one device."""
    check_shapes(x, w, stride)
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the temporal conv kernel takes bfloat16, got "
                            f"{name} {t.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("the temporal conv kernel takes x in "
                         "channels_last_3d memory")
    if w.shape[0] % 8:
        raise ValueError(f"the temporal conv kernel takes Co a multiple of "
                         f"8, got {w.shape[0]}")


def check_shapes(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty [B, C, T, H, W], got shape "
                         f"{tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 1, 1) \
            or w.shape[1] != x.shape[1]:
        raise ValueError(f"w must be [Co, {x.shape[1]}, 3, 1, 1], got shape "
                         f"{tuple(w.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def temporal_conv(x: torch.Tensor, w: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """The temporal conv of x [B, C, T, H, W] with w [Co, C, 3, 1, 1]: the
    plain version on the CPU, the hand kernel on the card (bf16,
    channels_last_3d in and out; anything else raises)."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        check_shapes(x, w, stride)
        return temporal_conv_plain(x, w, stride)
    check_kernel_args(x, w, stride)
    b, c, t, h, wd = x.shape
    co = w.shape[0]
    w2 = w[:, :, :, 0, 0].permute(2, 1, 0).contiguous()  # [3, C, Co]
    y = torch.empty((b, co, out_frames(t, stride), h, wd), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last_3d)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.temporal_conv_fwd(x.data_ptr(), w2.data_ptr(), y.data_ptr(),
                                   b, t, h * wd, c, co, stride, stream)
    if rc != 0:
        raise RuntimeError(f"temporal conv kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    profiling.count("temporal_conv.launches")
    return y


class TemporalConvFunction(torch.autograd.Function):
    """``temporal_conv`` forward; the backward of the conv3d it computes,
    from the x and w it was given (bf16 under autocast, as autocast's conv
    saves them)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return temporal_conv(x, w, stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad, x, w, None, [ctx.stride, 1, 1], list(PADDING), [1, 1, 1],
            False, [0, 0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None
