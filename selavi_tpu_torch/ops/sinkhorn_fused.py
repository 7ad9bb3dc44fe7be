"""Fused Sinkhorn-Knopp iteration: the Hopper kernel and its plain version.

One log-domain SK iteration in one read of ``M [N, K]`` (see
``csrc/fused_sk.cu`` for the design and its bound):

    log_beta_new   = -log N - LSE_k(M + log_alpha)          (row LSE)
    err            = sum_n |exp(log_beta - log_beta_new) - 1|
    log_alpha_next = log_r - LSE_n(M + log_beta_new[:, None])  (column LSE)

``fused_sk_iteration`` launches the CUDA kernel for CUDA tensors and raises
on anything it does not take; it uses ``fused_sk_iteration_plain`` only for
tensors on the CPU. The kernel library is compiled with ``nvcc`` from the
package's own source at first use, into ``build/selavi_tpu_torch/`` at the
root of the checkout.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from selavi_tpu_torch.ops import _build

SOURCE = _build.CSRC / "fused_sk.cu"
ROWS_PER_BLOCK = 256  # rows of M per block of pass 1
MAX_K = 512  # csrc/fused_sk.cu: 32 lanes x kMaxKpl columns held per row

# Kernel launches made through fused_sk_iteration (plain calls not counted).
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def build_library() -> Path:
    """Compile ``csrc/fused_sk.cu`` (see ``ops/_build.py``) and return the
    library's path."""
    return _build.build_library(SOURCE)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.sk_fused_iteration
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.sk_max_k.argtypes = []
        lib.sk_max_k.restype = ctypes.c_int
        if lib.sk_max_k() != MAX_K:
            raise RuntimeError("fused_sk.cu and MAX_K disagree")
        _lib = lib
    return _lib


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
    for name, t in (("M", m), ("log_alpha", log_alpha),
                    ("log_beta", log_beta), ("log_r", log_r)):
        if t.device != m.device:
            raise ValueError(f"{name} is on {t.device}, M on {m.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_sk_iteration(m, log_alpha, log_beta, log_r):
    """One fused SK iteration. ``m`` [N, K] fp32 or bf16; the vectors fp32.
    Returns ``(log_alpha_next [K], log_beta_new [N], err [])`` fp32."""
    global launches
    if m.device.type == "cpu":
        return fused_sk_iteration_plain(m, log_alpha, log_beta, log_r)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    _check(m, log_alpha, log_beta, log_r)
    lib = _library()
    n, k = m.shape
    n_blocks = math.ceil(n / ROWS_PER_BLOCK)
    dev = m.device
    alpha_out = torch.empty(k, dtype=torch.float32, device=dev)
    beta_out = torch.empty(n, dtype=torch.float32, device=dev)
    err_out = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * k * n_blocks + n_blocks, dtype=torch.float32,
                          device=dev)
    colmax = scratch[: k * n_blocks]
    colsum = scratch[k * n_blocks: 2 * k * n_blocks]
    err_part = scratch[2 * k * n_blocks:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sk_fused_iteration(
            m.data_ptr(), int(m.dtype == torch.bfloat16),
            log_alpha.data_ptr(), log_beta.data_ptr(), log_r.data_ptr(),
            alpha_out.data_ptr(), beta_out.data_ptr(), err_out.data_ptr(),
            colmax.data_ptr(), colsum.data_ptr(), err_part.data_ptr(),
            n, k, ROWS_PER_BLOCK, n_blocks, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused SK kernel launch failed: cudaError_t {rc}")
    launches += 1
    return alpha_out, beta_out, err_out
