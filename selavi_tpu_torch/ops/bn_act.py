"""Eval-mode BatchNorm, an optional residual add and an optional ReLU in
one pass: the Hopper kernel and its plain version.

    bn_act(x, weight, bias, mean, var, eps, relu, residual=None) -> y

``y = act(x * s[c] + t[c] (+ residual))`` with ``s = weight / sqrt(var +
eps)``, ``t = bias - mean * s``, c the channel (dim 1), act ReLU or the
identity: what ``F.batch_norm(training=False)``, ``+ residual`` and
``F.relu`` compute one after the other. y has x's dtype and strides.

``bn_act`` launches the CUDA kernel (``csrc/bn_act.cu``, see there for its
design and bound) for dense CUDA tensors, bf16 or fp32, with fp32
parameters, whose channels are their fastest dimension (channels_last,
channels_last_3d or ``[N, C]``: the video tower's maps) or lie outside the
spatial positions (contiguous NCHW or NCDHW: the audio tower's maps where
its spectrograms come from the card's log-mel); see ``layout``. On any
other CUDA input it raises (``check_kernel_args``): there is no fallback.
It runs ``bn_act_plain``, the three ops as the towers called them before,
for CPU tensors. The kernel's arithmetic is fp32 with one
rounding at the end; ``bn_act_plain`` rounds after the BatchNorm and again
after the add. The kernel library is compiled with ``nvcc`` at the first
launch (see ``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from selavi_tpu_torch.ops import _build
from selavi_tpu_torch.utils import profiling

SOURCE = _build.CSRC / "bn_act.cu"
MAX_CHANNELS = 4096
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# channels-fastest memory of a tensor of each rank
FORMATS = {2: torch.contiguous_format, 4: torch.channels_last,
           5: torch.channels_last_3d}

# Kernel launches made through bn_act (plain calls not counted).
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def build_library() -> Path:
    """Compile ``csrc/bn_act.cu`` (see ``ops/_build.py``) and return the
    library's path."""
    return _build.build_library(SOURCE)


def load_library(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/bn_act.cu`` and declare its C function."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.bn_act_fwd.argtypes = [ptr] * 7 + [ctypes.c_double, i64, i32, i64,
                                           i32, i32, ptr]
    lib.bn_act_fwd.restype = i32
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load_library(build_library())
    return _lib


def channels_fastest(t: torch.Tensor) -> bool:
    """Whether dim 1 (channels) is t's fastest dimension in dense memory:
    ``[N, C]`` contiguous, 4D channels_last or 5D channels_last_3d."""
    fmt = FORMATS.get(t.dim())
    return fmt is not None and t.is_contiguous(memory_format=fmt)


def layout(t: torch.Tensor):
    """The kernel's name for t's memory: ``"channels_fastest"``
    (``channels_fastest``), ``"planar"`` (a 4D or 5D contiguous tensor: a
    channel's positions next to each other), or None (neither: the kernel
    does not take it). A tensor that is both, as one with a single channel
    or position is, counts as channels fastest: its elements lie in the
    same order either way."""
    if channels_fastest(t):
        return "channels_fastest"
    if t.dim() in (4, 5) and t.is_contiguous():
        return "planar"
    return None


# ---------------------------------------------------------------- plain


def bn_act_plain(x, weight, bias, mean, var, eps: float, relu: bool,
                 residual=None):
    """The towers' composition: ``F.batch_norm`` in eval mode, then ``+
    residual``, then ``F.relu``, each rounding to its output's dtype."""
    y = F.batch_norm(x, mean, var, weight, bias, training=False, eps=eps)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


# ---------------------------------------------------------------- kernel


def kernel_takes(x, params, residual=None) -> bool:
    """Whether ``bn_act`` launches the kernel on these tensors: x on the
    card, bf16 or fp32, non-empty, in a ``layout`` the kernel takes, with 1
    <= C <= ``MAX_CHANNELS``; ``params`` (weight, bias, mean, var) fp32 and
    contiguous ``[C]`` on x's device; the residual, if any, of x's dtype,
    shape and layout."""
    if not (x.is_cuda and x.dtype in DTYPES and x.numel() > 0
            and layout(x) is not None):
        return False
    c = x.shape[1]
    if c > MAX_CHANNELS:
        return False
    for p in params:
        if (p.dtype != torch.float32 or p.device != x.device
                or p.shape != (c,) or not p.is_contiguous()):
            return False
    return residual is None or (residual.dtype == x.dtype
                                and residual.device == x.device
                                and residual.shape == x.shape
                                and layout(residual) == layout(x))


def check_kernel_args(x, params, residual=None) -> None:
    """Raises on what the kernel does not take (``kernel_takes``), naming
    it."""
    if kernel_takes(x, params, residual):
        return
    if not x.is_cuda:
        raise ValueError(f"the bn_act kernel runs on a CUDA card, got x on "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the bn_act kernel takes bfloat16 or float32, got "
                        f"{x.dtype}")
    if layout(x) is None:
        raise ValueError(f"the bn_act kernel takes dense tensors with "
                         f"channels as the fastest dimension ([N, C], "
                         f"channels_last, channels_last_3d) or contiguous "
                         f"4D or 5D ones, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    res = None if residual is None else (
        tuple(residual.shape), residual.dtype, residual.stride())
    raise ValueError(
        f"the bn_act kernel does not take x {tuple(x.shape)} on {x.device} "
        f"with parameters {[(tuple(p.shape), p.dtype) for p in params]} and "
        f"residual {res} (it takes 1 <= C <= {MAX_CHANNELS}, fp32 "
        f"contiguous [C] parameters on x's device, a residual of x's "
        f"dtype, shape and layout)")


def bn_act(x, weight, bias, mean, var, eps: float, relu: bool,
           residual=None):
    """Eval-mode BatchNorm of x with the running statistics ``mean`` and
    ``var``, then ``+ residual``, then ReLU where ``relu``: the plain
    version on the CPU, the kernel on the card (anything it does not take
    raises)."""
    global launches
    if x.device.type == "cpu":
        return bn_act_plain(x, weight, bias, mean, var, eps, relu, residual)
    params = (weight, bias, mean, var)
    check_kernel_args(x, params, residual)
    inner = 1 if layout(x) == "channels_fastest" else x[0, 0].numel()
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bn_act_fwd(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), *(p.data_ptr() for p in params), float(eps),
            x.numel(), x.shape[1], inner, DTYPES[x.dtype], int(bool(relu)),
            stream)
    if rc != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError_t {rc}")
    launches += 1
    profiling.count("bn_act.launches")
    return y
