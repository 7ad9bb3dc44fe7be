"""Fused Sinkhorn-Knopp iteration: the Hopper kernel and its plain version.

One log-domain SK iteration in one read of ``M [N, K]`` (see
``csrc/fused_sk.cu`` for the design and its bound):

    log_beta_new   = -log N - LSE_k(M + log_alpha)          (row LSE)
    err            = sum_n |exp(log_beta - log_beta_new) - 1|
    log_alpha_next = log_r - LSE_n(M + log_beta_new[:, None])  (column LSE)

``fused_sk_iteration`` launches the CUDA kernel for CUDA tensors and raises
on anything it does not take; it uses ``fused_sk_iteration_plain`` only for
tensors on the CPU. A solver passes the outputs (``out=``) and the
kernel's scratch (``workspace=``, from ``make_workspace(m)``) once per
solve, so that an iteration allocates nothing. The kernel library is compiled with ``nvcc``
from the package's own source at first use, into ``build/selavi_tpu_torch/``
at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from selavi_tpu_torch.ops import _build

SOURCE = _build.CSRC / "fused_sk.cu"
MAX_K = 512  # csrc/fused_sk.cu: 32 lanes x kMaxKpl columns held per row
# csrc/fused_sk.cu's tiling, which plan() mirrors.
CONSUMER_WARPS = 12  # kWarps
MAX_STAGES = 8
RING_BYTES = 96 * 1024  # kRingBytes: the ring's size, at least 3 stages
HEADER_BYTES = 256  # the ring's mbarriers and the ticket flag
SMEM_LIMIT = 232448  # dynamic shared memory a block may have
GROUP = 16  # blocks merged by one group ticket
ALIGN = 16  # bytes: M's start, for the bulk copies

# Kernel launches made through fused_sk_iteration (plain calls not counted).
launches = 0

_lib = None


class Plan(NamedTuple):
    """How the kernel tiles an iteration over M [n, k] (``sk_plan``)."""
    tile_rows: int  # rows of M a tile, bulk-copied into one ring stage
    grid: int  # persistent blocks: block b takes tiles b, b + grid, ...
    stage_bytes: int
    stages: int
    smem_bytes: int  # dynamic shared memory of a block
    tiles: int
    bulk_bytes_last: int  # the last tile's bytes moved by its bulk copy
    rest_bytes_last: int  # the bytes past them, copied by ordinary loads
    groups: int  # ticket groups of the cross-block merge
    scratch_floats: int  # partials: (grid + groups) x (k + 1)


class Workspace(NamedTuple):
    """The kernel's scratch for one solve: partial LSEs and errors, and the
    ticket counters (zeroed here; each launch leaves them zero)."""
    n: int
    k: int
    dtype: torch.dtype
    device: int  # the card's index
    scratch: torch.Tensor
    counters: torch.Tensor


def plan(n: int, k: int, dtype: torch.dtype, sm_count: int) -> Plan:
    """The kernel's tiling of M [n, k] of ``dtype`` on a card of
    ``sm_count`` SMs (the mirror of ``csrc/fused_sk.cu::plan_of``)."""
    if n <= 0 or not 0 < k <= MAX_K or sm_count <= 0:
        raise ValueError(f"no plan for n={n}, k={k}, sm_count={sm_count}")
    elem = 2 if dtype == torch.bfloat16 else 4
    # rows_per_warp: 4, or 2 for rows of more than 12 x 32 columns
    tile_rows = CONSUMER_WARPS * (2 if -(-k // 32) > 12 else 4)
    tiles = -(-n // tile_rows)
    grid = min(sm_count, tiles, GROUP * GROUP)
    stage_bytes = tile_rows * k * elem
    stages = min(MAX_STAGES, max(3, RING_BYTES // stage_bytes),
                 (SMEM_LIMIT - HEADER_BYTES) // stage_bytes)
    last = (n - (tiles - 1) * tile_rows) * k * elem
    groups = -(-grid // GROUP)
    return Plan(tile_rows, grid, stage_bytes, stages,
                HEADER_BYTES + stages * stage_bytes, tiles, last // 16 * 16,
                last % 16, groups, (grid + groups) * (k + 1))


def reset_launches() -> None:
    global launches
    launches = 0


def build_library() -> Path:
    """Compile ``csrc/fused_sk.cu`` (see ``ops/_build.py``) and return the
    library's path."""
    return _build.build_library(SOURCE)


def load_library(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/fused_sk.cu`` and declare its C functions."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sk_fused_iteration.argtypes = (
        [ptr, i32] + [ptr] * 8 + [i32] * 4 + [ptr])
    lib.sk_fused_iteration.restype = i32
    lib.sk_plan.argtypes = [i32] * 4 + [ptr]
    lib.sk_plan.restype = i32
    lib.sk_kernel_info.argtypes = [i32, i32, ptr]
    lib.sk_kernel_info.restype = i32
    for fn in (lib.sk_max_k, lib.sk_launches_per_iteration):
        fn.argtypes = []
        fn.restype = i32
    if lib.sk_max_k() != MAX_K:
        raise RuntimeError("fused_sk.cu and MAX_K disagree")
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load_library(build_library())
    return _lib


def library_plan(n: int, k: int, dtype: torch.dtype, sm_count: int) -> Plan:
    """The library's own plan (``sk_plan``), to hold ``plan()`` against."""
    out = (ctypes.c_int * len(Plan._fields))()
    if _library().sk_plan(n, k, int(dtype == torch.bfloat16), sm_count,
                          ctypes.addressof(out)):
        raise ValueError(f"the library has no plan for n={n}, k={k}")
    return Plan(*out)


def kernel_info(k: int, dtype: torch.dtype) -> dict:
    """Registers a thread and local-memory bytes (spills) of the kernel
    instance that an M with ``k`` columns of ``dtype`` takes."""
    out = (ctypes.c_int * 2)()
    rc = _library().sk_kernel_info(k, int(dtype == torch.bfloat16),
                                   ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError_t {rc}")
    return {"registers": out[0], "local_bytes": out[1]}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _current_stream(index: int) -> int:
    """The handle of PyTorch's current stream on card ``index``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # a few microseconds less a call
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def fused_sk_iteration_plain(m, log_alpha, log_beta, log_r):
    """The fused iteration in plain torch, with the kernel's arithmetic
    (``exp(x) - 1`` in the error, the 1e-38 floor). Returns
    ``(log_alpha_next [K], log_beta_new [N], err scalar)``, all fp32."""
    mf = m.float()
    n = m.shape[0]
    log_c = -torch.log(torch.tensor(float(n), dtype=torch.float32,
                                    device=m.device))
    z = mf + log_alpha[None, :]
    zmax = z.amax(dim=1)
    zsum = torch.exp(z - zmax[:, None]).sum(dim=1)
    log_beta_new = log_c - (zmax + torch.log(zsum))
    err = torch.abs(torch.exp(log_beta - log_beta_new) - 1.0).sum()
    w = mf + log_beta_new[:, None]
    cmax = w.amax(dim=0)
    csum = torch.exp(w - cmax[None, :]).sum(dim=0)
    log_alpha_next = log_r - (cmax + torch.log(torch.clamp(csum, min=1e-38)))
    return log_alpha_next, log_beta_new, err


def _check(m, log_alpha, log_beta, log_r):
    if m.dim() != 2:
        raise ValueError(f"M must be [N, K], got shape {tuple(m.shape)}")
    n, k = m.shape
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"M must be float32 or bfloat16, got {m.dtype}")
    if k > MAX_K:
        raise ValueError(
            f"K={k} exceeds the kernel's register/shared-memory budget "
            f"(K <= {MAX_K})"
        )
    if n * k >= 2 ** 31:
        raise ValueError(f"N*K={n * k} exceeds the kernel's int32 indexing")
    for name, t, size in (("log_alpha", log_alpha, k), ("log_beta", log_beta, n),
                          ("log_r", log_r, k)):
        if t.dtype != torch.float32 or t.shape != (size,):
            raise TypeError(
                f"{name} must be float32 of shape ({size},), got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    where = m.get_device()
    for name, t in (("M", m), ("log_alpha", log_alpha),
                    ("log_beta", log_beta), ("log_r", log_r)):
        if t.get_device() != where:
            raise ValueError(f"{name} is on {t.device}, M on {m.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m.data_ptr() % ALIGN:
        raise ValueError(f"M must start on a {ALIGN}-byte boundary (the "
                         f"kernel bulk-copies whole rows)")


def _check_out(out, m):
    n, k = m.shape
    where = m.get_device()
    for name, t, shape in (("alpha_out", out[0], (k,)),
                           ("beta_out", out[1], (n,)), ("err_out", out[2], ())):
        if (t.dtype != torch.float32 or t.shape != shape
                or t.get_device() != where or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 of shape "
                             f"{shape} on {m.device}")


def make_workspace(m) -> Workspace | None:
    """The scratch of the kernel for iterations over ``m`` (None for a CPU
    ``m``, whose plain version needs none)."""
    if m.device.type != "cuda":
        return None
    n, k = m.shape
    p = plan(n, k, m.dtype, sm_count(m.device.index))
    return Workspace(
        n, k, m.dtype, m.device.index,
        torch.empty(p.scratch_floats, dtype=torch.float32, device=m.device),
        torch.zeros(p.groups + 1, dtype=torch.int32, device=m.device))


def fused_sk_iteration(m, log_alpha, log_beta, log_r, out=None,
                       workspace=None):
    """One fused SK iteration. ``m`` [N, K] fp32 or bf16; the vectors fp32.
    Returns ``(log_alpha_next [K], log_beta_new [N], err [])`` fp32: the
    tensors of ``out`` when given (written in place; none may alias an
    input). ``workspace`` is ``make_workspace(m)``, made anew when not
    given."""
    global launches
    if m.device.type == "cpu":
        result = fused_sk_iteration_plain(m, log_alpha, log_beta, log_r)
        if out is None:
            return result
        for dst, src in zip(out, result):
            dst.copy_(src)
        return tuple(out)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    _check(m, log_alpha, log_beta, log_r)
    n, k = m.shape
    dev = m.device
    if out is None:
        out = (torch.empty(k, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty((), dtype=torch.float32, device=dev))
    else:
        _check_out(out, m)
    ws = workspace
    if ws is None:
        ws = make_workspace(m)
    elif (ws.n, ws.k, ws.dtype, ws.device) != (n, k, m.dtype, dev.index):
        raise ValueError("the workspace was made for another M")
    rc = _library().sk_fused_iteration(
        m.data_ptr(), int(m.dtype == torch.bfloat16),
        log_alpha.data_ptr(), log_beta.data_ptr(), log_r.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        ws.scratch.data_ptr(), ws.counters.data_ptr(), n, k,
        sm_count(dev.index), dev.index, _current_stream(dev.index),
    )
    if rc != 0:
        raise RuntimeError(f"fused SK kernel launch failed: cudaError_t {rc}")
    launches += 1
    return tuple(out)
