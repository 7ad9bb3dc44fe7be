"""Sinkhorn-Knopp label assignment in the log domain
(``selavi_tpu/selflabel/sinkhorn.py``), as a host loop over device steps.

With ``M = (lambda/2) * log_ps`` (fp32, optionally stored bf16) iterate

    log_alpha = log_r - LSE_n(M + log_beta[:, None])
    log_beta  = -log N - LSE_k(M + log_alpha[None, :])

until the reference rule stops it: ``sum |beta_old / beta_new - 1| <= tol``
(tol 0.1), checked every 10 iterations, or 2000 iterations. Labels are
``argmax_k (M + log_alpha)``. Under bf16 M two more exits are on (as in the
JAX package): a plateau below the bf16 resolution bound ``N * 2^-8`` and a
stall over two windows of 8 checks. The host reads the error only at check
iterations; between them the iterations queue on the device unsynced.

Backends:

* ``"fused"``: one read of M per iteration through
  ``ops.sinkhorn_fused.fused_sk_iteration`` (the CUDA kernel for a CUDA M,
  its plain version for a CPU M). Its alpha runs a half-step ahead of the
  beta chain, so the loop carries the previous alpha and the labels pair
  with the same alpha as the plain backend: labels and iters match. The
  solve allocates the kernel's outputs and scratch once: alpha and beta
  each ping-pong between two buffers, on the CPU too (where the plain
  version writes into them).
* ``"plain"``: the two-sweep loop in plain torch (``expm1`` error term).
* ``"auto"``: ``"fused"`` for a CUDA M, ``"plain"`` on the CPU. There is no
  fallback from the kernel on CUDA.

The JAX package's names ``"pallas"`` and ``"xla"`` are taken as
``"fused"`` and ``"plain"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from selavi_tpu_torch.ops.sinkhorn_fused import (
    fused_sk_iteration,
    make_workspace,
)

CHECK_EVERY = 10  # iterations between error checks (reference rule)
STALL_WINDOW = 8  # checks per no-net-improvement window
BACKEND_ALIASES = {"pallas": "fused", "xla": "plain"}  # the JAX names


class SinkhornResult(NamedTuple):
    labels: torch.Tensor  # [N] int64 row-argmax assignments (on M's device)
    cost: float  # reference transport cost
    err: float  # marginal error at the last check
    iters: int  # iterations executed


def resolve_backend(backend: str, device: torch.device) -> str:
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend == "auto":
        return "fused" if device.type == "cuda" else "plain"
    if backend not in ("fused", "plain"):
        raise ValueError(f"unknown SK backend {backend!r}")
    return backend


class _StopRule:
    """The JAX solver's loop condition and check update, in float32."""

    def __init__(self, n: int, tol: float, max_iters: int, plateau_exit: bool):
        self.tol = np.float32(tol)
        self.max_iters = max_iters
        self.plateau_exit = plateau_exit
        self.floor_bound = np.float32(n * 2.0 ** -8) if plateau_exit else (
            np.float32(0.0))
        self.err = np.float32(1e6)
        self.stuck = 0
        self.err_ref = np.float32(1e6)
        self.chk = 0
        self.stalls = 0

    def keep_going(self, it: int) -> bool:
        stop = self.stuck >= 2 and self.err <= self.floor_bound
        if self.plateau_exit:
            stop = stop or self.stalls >= 2
        return bool(self.err > self.tol) and it < self.max_iters and not stop

    def check(self, err_new: np.float32) -> None:
        improved = err_new < np.float32(0.99) * self.err
        self.stuck = 0 if improved else self.stuck + 1
        self.chk += 1
        if self.chk % STALL_WINDOW == 0:
            stalled = err_new >= np.float32(0.999) * self.err_ref
            self.stalls = self.stalls + 1 if stalled else 0
            self.err_ref = err_new
        self.err = err_new


def sinkhorn_knopp(
    log_ps: torch.Tensor,
    log_r: torch.Tensor,
    lamb: float = 20.0,
    tol: float = 1e-1,
    max_iters: int = 2000,
    backend: str = "auto",
    m_bf16: bool = False,
) -> SinkhornResult:
    """Run SK scaling iterations on ``log_ps`` [N, K] (log joint
    probabilities, not yet scaled by lambda/2) under the column marginal
    ``log_r`` [K] (normalized; uniform is ``-log K``)."""
    backend = resolve_backend(backend, log_ps.device)
    n = log_ps.shape[0]
    m = (0.5 * lamb) * log_ps.float()
    if m_bf16:
        m = m.to(torch.bfloat16)
    m = m.contiguous()
    log_r = log_r.float().contiguous()
    log_c = -torch.log(torch.tensor(float(n), dtype=torch.float32,
                                    device=m.device))
    rule = _StopRule(n, tol, max_iters, plateau_exit=m_bf16)

    log_beta = log_c.expand(n).clone()
    log_alpha = log_r - torch.logsumexp(m + log_beta[:, None], dim=0)
    alpha_used = log_alpha  # the alpha the last beta update was computed from
    if backend == "fused":
        # Iteration it reads alphas[it % 2], betas[it % 2] and writes the
        # other two; the alpha it read stays intact until the next one.
        alphas = (log_alpha, torch.empty_like(log_alpha))
        betas = (log_beta, torch.empty_like(log_beta))
        err_buf = torch.empty((), dtype=torch.float32, device=m.device)
        workspace = make_workspace(m)
    it = 0
    while rule.keep_going(it):
        if backend == "fused":
            src, dst = it % 2, 1 - it % 2
            alpha_used = alphas[src]
            log_alpha, log_beta_new, err_new = fused_sk_iteration(
                m, alphas[src], betas[src], log_r,
                out=(alphas[dst], betas[dst], err_buf), workspace=workspace)
        else:
            log_alpha = log_r - torch.logsumexp(m + log_beta[:, None], dim=0)
            alpha_used = log_alpha
            log_beta_new = log_c - torch.logsumexp(m + log_alpha[None, :],
                                                   dim=1)
            err_new = None
            if it % CHECK_EVERY == 0:
                err_new = torch.abs(torch.expm1(log_beta - log_beta_new)).sum()
        if it % CHECK_EVERY == 0:
            rule.check(np.float32(err_new.item()))
        log_beta = log_beta_new
        it += 1

    labels = torch.argmax(m + alpha_used[None, :], dim=1)
    picked = torch.gather(m, 1, labels[:, None])[:, 0]
    cost = -(1.0 / lamb) * picked.float().sum().item() / n
    return SinkhornResult(labels, cost, float(rule.err), it)


def sinkhorn_assign(
    logits_v: torch.Tensor,
    logits_a: torch.Tensor,
    log_r: Optional[torch.Tensor] = None,
    lamb: float = 20.0,
    tol: float = 1e-1,
    max_iters: int = 2000,
    backend: str = "auto",
) -> SinkhornResult:
    """Assign labels from raw per-modality head logits [N, K]:
    ``PS = softmax(logits_v) * softmax(logits_a)`` as a log-space sum."""
    log_ps = (torch.log_softmax(logits_v.float(), dim=1)
              + torch.log_softmax(logits_a.float(), dim=1))
    if log_r is None:
        k = logits_v.shape[1]
        log_r = torch.full((k,), -math.log(k), dtype=torch.float32,
                           device=logits_v.device)
    return sinkhorn_knopp(log_ps, log_r, lamb=lamb, tol=tol,
                          max_iters=max_iters, backend=backend)
