"""3x3 stride-1 "same" convolution, channels last: the Hopper kernels and
their plain versions.

The port's counterpart of the Pallas probe ``experiments/pallas_conv3x3.py``
(``conv3x3_pallas``, ``conv3x3_dgrad_pallas``, ``conv3x3_wgrad_pallas``),
with its layouts: activations NHWC ``[N, H, W, C]``, weights HWIO
``[3, 3, C, Co]``. See ``csrc/conv3x3.cu`` for the kernels' design and
bound.

    conv3x3(x, w)        -> [N, H, W, Co] in x's dtype (fp32 accumulation);
                            bf16 runs on the wgmma kernel where
                            ``fwd_route`` says so
    conv3x3_dgrad(g, w)  -> [N, H, W, C] in g's dtype: the forward kernels
                            with w rotated and io-transposed
    conv3x3_wgrad(x, g)  -> [3, 3, C, Co] fp32; bf16 with C, Co % 8 == 0
                            runs on the wgmma kernel (``wgrad_route``)

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
# The kernels of the forward (which the dgrad reuses) and of the weight
# gradient, in the order of the C functions' `route` codes: fp32 on the
# CUDA cores, bf16 on wmma (any C, Co), bf16 on wgmma (C, Co % 8 == 0,
# 16-byte aligned tensors; the forward's also needs its resident weights
# and ring to fit FWD_SMEM_LIMIT).
ROUTES = ("fp32", "wmma", "wgmma")
# The wgmma forward's dynamic shared memory (as ``csrc/conv3x3.cu``'s
# fwd_wgmma_smem): 1 KB to align, the block's weights (9 * C_pad * BN bf16,
# C_pad = C rounded up to FWD_SLICE, BN = 64 for Co <= 64, else 128), for
# each of its two warpgroups an output tile (64 x BN bf16) and a ring of
# FWD_STAGES halo tiles (66 rows of 128 bytes) with an 8-byte mbarrier
# each, and one zero row; at most FWD_SMEM_LIMIT, what a block of an H100
# may have.
FWD_SLICE = 64
FWD_STAGES = 3
FWD_STAGE_BYTES = 66 * 128
FWD_SMEM_LIMIT = 232448
# The fp32 kernels' dynamic shared memory (as ``csrc/conv3x3.cu``'s
# conv3x3_f32_smem): slices F32_DEPTH values deep. The forward's 2 stages
# hold an A tile of F32_DEPTH x (256 + 4) floats (256 pixels, a pad) and a
# B tile of F32_DEPTH x BN for Co > 64 (BN = 128, one tap a slice), or of 3
# x F32_DEPTH x BN for Co <= 64 (BN = 64, a tap row a slice: the three dx
# read one halo tile). The
# weight gradient's F32_WGRAD_STAGES stages hold a halo tile of F32_DEPTH + 2
# pixels x 64 channels and a g tile of F32_DEPTH x 128, beside a zero row
# of 64 floats.
F32_DEPTH = 32
F32_WGRAD_STAGES = 6
# Weight gradient: pixel ranges, each a multiple of SPLIT_ALIGN, whose
# partials are reduced in a fixed order. wmma: at most MAX_SPLITS ranges of
# at least MIN_SPLIT_PIXELS. wgmma and fp32 (one block on each SM): enough
# ranges that their 3 * (C blocks) * (Co blocks) * S blocks fill
# WAVE_BLOCKS, the H100's SM count, once. Both depend on the shape alone,
# not on the card.
MAX_SPLITS = 256
MIN_SPLIT_PIXELS = 256
WAVE_BLOCKS = 132
# channels of C and of Co per wgmma or fp32 weight-gradient block
TILE_ROWS, TILE_COLS = 64, 128
SPLIT_ALIGN = 64  # pixels; a multiple of every kernel's slice depth
INT32_LIMIT = 2 ** 31  # the kernels index pixels and channels in int32
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made through each wrapper (plain calls not counted), and
# the launches by route: of the forward and the dgrad each, and of the
# weight gradient.
launches = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}
fwd_routes = {name: {route: 0 for route in ROUTES}
              for name in ("conv3x3", "conv3x3_dgrad")}
wgrad_routes = {route: 0 for route in ROUTES}

_lib = None


def reset_launches() -> None:
    for counts in (launches, wgrad_routes, *fwd_routes.values()):
        for name in counts:
            counts[name] = 0


def build_library() -> Path:
    """Compile ``csrc/conv3x3.cu`` (see ``ops/_build.py``) and return the
    library's path."""
    return _build.build_library(SOURCE)


def load_library(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/conv3x3.cu`` and declare its C functions."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.conv3x3_fwd.restype = i32
    lib.conv3x3_fwd_wgmma_smem.argtypes = [i32, i32]
    lib.conv3x3_fwd_wgmma_smem.restype = ctypes.c_longlong
    lib.conv3x3_f32_smem.argtypes = [i32, i32]
    lib.conv3x3_f32_smem.restype = ctypes.c_longlong
    lib.conv3x3_wgrad_scratch.argtypes = [i32, i32, i32]
    lib.conv3x3_wgrad_scratch.restype = ctypes.c_longlong
    lib.conv3x3_wgrad.argtypes = (
        [ptr, ptr, ptr, ctypes.c_longlong, ptr] + [i32] * 8 + [ptr]
    )
    lib.conv3x3_wgrad.restype = i32
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load_library(build_library())
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


def fwd_smem_bytes(c: int, co: int) -> int:
    """Dynamic shared memory of the wgmma forward for C -> Co channels."""
    bn = 64 if co <= 64 else 128
    c_pad = -(-c // FWD_SLICE) * FWD_SLICE
    return (1024 + 9 * c_pad * bn * 2 + 2 * 64 * bn * 2
            + 2 * FWD_STAGES * (FWD_STAGE_BYTES + 8) + 128)


def f32_smem_bytes(kernel: str, co: int = 0) -> int:
    """Dynamic shared memory of the fp32 ``kernel`` ("forward", whose tile
    follows its ``co`` output channels, or "wgrad")."""
    if kernel == "wgrad":
        return (F32_WGRAD_STAGES * ((F32_DEPTH + 2) * 64 + F32_DEPTH * 128)
                + 64) * 4
    bn = 64 if co <= 64 else 128
    taps = 3 if bn == 64 else 1
    return 2 * (F32_DEPTH * (256 + 4) + taps * F32_DEPTH * bn) * 4


def fwd_route(dtype: torch.dtype, c: int, co: int,
              aligned: bool = True) -> str:
    """The kernel that computes the forward of C -> Co channels on the
    card (the dgrad asks with its rotated shape, C and Co swapped): "wgmma"
    for bf16 with C and Co multiples of 8, 16-byte aligned tensors and
    resident weights plus ring within FWD_SMEM_LIMIT; "wmma" for the other
    bf16 shapes; "fp32" for fp32."""
    if dtype == torch.float32:
        return "fp32"
    if (c % 8 == 0 and co % 8 == 0 and aligned
            and fwd_smem_bytes(c, co) <= FWD_SMEM_LIMIT):
        return "wgmma"
    return "wmma"


def wgrad_route(dtype: torch.dtype, c: int, co: int,
                aligned: bool = True) -> str:
    """The kernel that computes the weight gradient on the card: "wgmma"
    for bf16 with C and Co multiples of 8 and 16-byte aligned tensors,
    "wmma" for the other bf16 shapes, "fp32" for fp32."""
    if dtype == torch.float32:
        return "fp32"
    if c % 8 == 0 and co % 8 == 0 and aligned:
        return "wgmma"
    return "wmma"


def split_plan(route: str, pixels: int, c: int,
               co: int) -> tuple[int, int]:
    """(splits, pixels per split) of ``route``'s reduction over ``pixels``
    = N*H*W output pixels of C -> Co channels (see WAVE_BLOCKS)."""
    if route in ("wgmma", "fp32"):
        tiles = 3 * -(-c // TILE_ROWS) * -(-co // TILE_COLS)
        per = -(-pixels // -(-WAVE_BLOCKS // tiles))
    else:
        per = max(MIN_SPLIT_PIXELS, -(-pixels // MAX_SPLITS))
    per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-pixels // per), per


# ---------------------------------------------------------------- kernels


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def _forward_kernel(name: str, x: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """The forward kernel that ``fwd_route`` names, on x [N, H, W, C] and
    w [3, 3, C, Co]; counted under ``name``."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    _check_index_range(n, h, wd, c, co)
    lib = _library()
    w2 = w.reshape(9 * c, co).to(x.dtype).contiguous()
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    route = fwd_route(x.dtype, c, co, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, w2, y)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_fwd(x.data_ptr(), w2.data_ptr(), y.data_ptr(),
                             ROUTES.index(route), n, h, wd, c, co, stream)
    _raise_on(rc, f"{name} ({route})")
    launches[name] += 1
    fwd_routes[name][route] += 1
    return y


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'same' conv: x [N, H, W, C], w [3, 3, C, Co] ->
    [N, H, W, Co] in x's dtype.

    On the card the shape picks one of three hand kernels (``fwd_route``):
    bf16 on wgmma where it fits, other bf16 on wmma, fp32 on the CUDA
    cores. None stands in for another: a failed build or launch raises."""
    _check_activation("x", x)
    _check_weight(w, 2, x.shape[3])
    if _device_of(("x", x), ("w", w)).type == "cpu":
        return conv3x3_plain(x, w)
    return _forward_kernel("conv3x3", x, w)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of the conv: g [N, H, W, Co], w [3, 3, C, Co] -> [N, H, W, C] in
    g's dtype (the forward kernel on the rotated, io-transposed weights)."""
    _check_activation("g", g)
    _check_weight(w, 3, g.shape[3])
    if _device_of(("g", g), ("w", w)).type == "cpu":
        return conv3x3_dgrad_plain(g, w)
    return _forward_kernel("conv3x3_dgrad", g, _rotate(w))


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW of the conv: x [N, H, W, C], g [N, H, W, Co] of one dtype ->
    [3, 3, C, Co] fp32.

    On the card the shape picks one of three hand kernels
    (``wgrad_route``): bf16 with C and Co multiples of 8 (and 16-byte
    aligned tensors) runs on wgmma, other bf16 shapes on wmma with element
    loads, fp32 on the CUDA cores. None stands in for another: a failed
    build or launch raises."""
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
    route = wgrad_route(x.dtype, c, co, aligned=(
        x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0))
    lib = _library()
    splits, per = split_plan(route, n * h * wd, c, co)
    floats = lib.conv3x3_wgrad_scratch(c, co, splits)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_wgrad(x.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                               floats, out.data_ptr(),
                               ROUTES.index(route), n, h, wd, c, co,
                               splits, per, stream)
    _raise_on(rc, f"conv3x3 weight-gradient ({route})")
    launches["conv3x3_wgrad"] += 1
    wgrad_routes[route] += 1
    return out
