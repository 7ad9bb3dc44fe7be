"""3x3 stride-1 "same" convolution, channels last: the Hopper kernels and
their plain versions.

The port's counterpart of the Pallas probe ``experiments/pallas_conv3x3.py``
(``conv3x3_pallas``, ``conv3x3_dgrad_pallas``, ``conv3x3_wgrad_pallas``),
with its layouts: activations NHWC ``[N, H, W, C]``, weights HWIO
``[3, 3, C, Co]``. See ``csrc/conv3x3.cu`` for the kernels' design and
bound.

    conv3x3(x, w)        -> [N, H, W, Co] in x's dtype (fp32 accumulation)
    conv3x3_dgrad(g, w)  -> [N, H, W, C] in g's dtype: the forward kernel
                            with w rotated and io-transposed
    conv3x3_wgrad(x, g)  -> [3, 3, C, Co] fp32

Each wrapper launches its CUDA kernel for CUDA tensors and raises on
anything the kernel does not take; it runs its ``*_plain`` version only
for tensors on the CPU. The plain versions spell the convolution out as
the probe's kernels do: pad, the 9 shifted windows in dy, dx, channel
order (the JAX ``w.reshape(9C, Co)`` order), then an fp32 matmul. The
kernel library is compiled with ``nvcc`` at the first launch (see
``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from selavi_tpu_torch.ops import _build

SOURCE = _build.CSRC / "conv3x3.cu"
MAX_SPLITS = 256  # weight gradient: pixel ranges reduced in a fixed order
MIN_SPLIT_PIXELS = 256
SPLIT_ALIGN = 64  # pixels; a multiple of every kernel's slice depth
INT32_LIMIT = 2 ** 31  # the kernels index pixels and channels in int32
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made through each wrapper (plain calls not counted).
launches = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}

_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_library() -> Path:
    """Compile ``csrc/conv3x3.cu`` (see ``ops/_build.py``) and return the
    library's path."""
    return _build.build_library(SOURCE)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
        lib.conv3x3_fwd.restype = i32
        lib.conv3x3_wgrad_scratch.argtypes = [i32, i32, i32]
        lib.conv3x3_wgrad_scratch.restype = ctypes.c_longlong
        lib.conv3x3_wgrad.argtypes = (
            [ptr, ptr, ptr, ctypes.c_longlong, ptr] + [i32] * 8 + [ptr]
        )
        lib.conv3x3_wgrad.restype = i32
        _lib = lib
    return _lib


# ---------------------------------------------------------------- plain


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> fp32 [N*H*W, 9C], columns in dy, dx, channel order."""
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wins = [xp[:, dy:dy + h, dx:dx + w, :]
            for dy in range(3) for dx in range(3)]
    return torch.cat(wins, dim=3).reshape(n * h * w, 9 * c)


def _rotate(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, Co] -> [3, 3, Co, C]: the dgrad weights of the probe's
    ``jnp.transpose(w[::-1, ::-1], (0, 1, 3, 2))``."""
    return w.flip((0, 1)).transpose(2, 3)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n, h, wd, c = x.shape
    co = w.shape[3]
    w2 = w.reshape(9 * c, co).to(x.dtype).float()
    return (_im2col(x) @ w2).reshape(n, h, wd, co).to(x.dtype)


def conv3x3_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv3x3_plain(g, _rotate(w))


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    c, co = x.shape[3], g.shape[3]
    return (_im2col(x).T @ g.reshape(-1, co).float()).reshape(3, 3, c, co)


# ---------------------------------------------------------------- checks


def _check_activation(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be [N, H, W, C], got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty: shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (channels last)")


def _check_weight(w: torch.Tensor, axis: int, channels: int) -> None:
    """w must be [3, 3, C, Co] with ``channels`` on ``axis`` (2: C, 3: Co)."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"w must be [3, 3, C, Co], got shape "
                         f"{tuple(w.shape)}")
    if w.dtype not in DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if w.shape[axis] != channels:
        raise ValueError(f"w {tuple(w.shape)} does not match the "
                         f"activation's {channels} channels")


def _device_of(*named) -> torch.device:
    """The one device of the named tensors; raises on a mix or on a device
    that neither the kernels nor the plain versions serve."""
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: " + ", ".join(
            f"{name} on {t.device}" for name, t in named))
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _check_index_range(n: int, h: int, w: int, c: int, co: int) -> None:
    if n * h * w * max(c, co) >= INT32_LIMIT:
        raise ValueError(
            f"N*H*W*max(C, Co) = {n * h * w * max(c, co)} exceeds the "
            f"kernels' int32 indexing")


def split_plan(pixels: int) -> tuple[int, int]:
    """(splits, pixels per split) of the weight gradient's reduction over
    ``pixels`` = N*H*W output pixels: at most MAX_SPLITS ranges of at
    least MIN_SPLIT_PIXELS, each a multiple of SPLIT_ALIGN."""
    per = max(MIN_SPLIT_PIXELS, -(-pixels // MAX_SPLITS))
    per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-pixels // per), per


# ---------------------------------------------------------------- kernels


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def _forward_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on x [N, H, W, C] and w [3, 3, C, Co]."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    _check_index_range(n, h, wd, c, co)
    lib = _library()
    w2 = w.reshape(9 * c, co).to(x.dtype).contiguous()
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_fwd(x.data_ptr(), w2.data_ptr(), y.data_ptr(),
                             int(x.dtype == torch.bfloat16), n, h, wd, c, co,
                             stream)
    _raise_on(rc, "conv3x3 forward")
    return y


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'same' conv: x [N, H, W, C], w [3, 3, C, Co] ->
    [N, H, W, Co] in x's dtype."""
    _check_activation("x", x)
    _check_weight(w, 2, x.shape[3])
    if _device_of(("x", x), ("w", w)).type == "cpu":
        return conv3x3_plain(x, w)
    y = _forward_kernel(x, w)
    launches["conv3x3"] += 1
    return y


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of the conv: g [N, H, W, Co], w [3, 3, C, Co] -> [N, H, W, C] in
    g's dtype (the forward kernel on the rotated, io-transposed weights)."""
    _check_activation("g", g)
    _check_weight(w, 3, g.shape[3])
    if _device_of(("g", g), ("w", w)).type == "cpu":
        return conv3x3_dgrad_plain(g, w)
    dx = _forward_kernel(g, _rotate(w))
    launches["conv3x3_dgrad"] += 1
    return dx


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW of the conv: x [N, H, W, C], g [N, H, W, Co] of one dtype ->
    [3, 3, C, Co] fp32."""
    _check_activation("x", x)
    _check_activation("g", g)
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ "
                         f"in N, H or W")
    if g.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} but g is {g.dtype}")
    if _device_of(("x", x), ("g", g)).type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    n, h, wd, c = x.shape
    co = g.shape[3]
    _check_index_range(n, h, wd, c, co)
    lib = _library()
    splits, per = split_plan(n * h * wd)
    floats = lib.conv3x3_wgrad_scratch(c, co, splits)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_wgrad(x.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                               floats, out.data_ptr(),
                               int(x.dtype == torch.bfloat16), n, h, wd, c,
                               co, splits, per, stream)
    _raise_on(rc, "conv3x3 weight-gradient")
    launches["conv3x3_wgrad"] += 1
    return out
