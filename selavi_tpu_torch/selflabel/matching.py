"""Modality alignment: permute audio-head clusters to match video
(``selavi_tpu/selflabel/matching.py``).

At the first SK step, per head, a greedy random-swap search over column
permutations minimizes ``sum_n sum_k |softmax_v[n,k] - softmax_a[n,perm(k)]|``
(reference sk_utils.py:424-467). The cost decomposes per column pair, so
``C[i, j] = sum_n |v[n, i] - a[n, j]|`` is computed once on the device
(streamed over N) and the sequential swap loop runs on the host over C:
in the C++ data runtime (``selavi_tpu_torch.native``) when g++ built it,
as in the JAX package, and in the Python loop otherwise.
"""

from __future__ import annotations

import numpy as np
import torch


def column_cost_matrix(v: torch.Tensor, a: torch.Tensor,
                       block: int = 1024) -> torch.Tensor:
    """C[i, j] = sum_n |v[n, i] - a[n, j]| for v, a of shape [N, K], fp32.

    Streamed over N in blocks so the [block, K, K] intermediate stays small
    (block 1024 at K=309 is ~0.4 GB)."""
    n, k = v.shape
    v = v.float()
    a = a.float()
    c = torch.zeros(k, k, dtype=torch.float32, device=v.device)
    for s in range(0, n, block):
        vb, ab = v[s:s + block], a[s:s + block]
        c += torch.abs(vb[:, :, None] - ab[:, None, :]).sum(dim=0)
    return c


def greedy_swap_match(
    cost: np.ndarray,
    steps: int = 50000,
    restarts: int = 2,
    patience: int = 1000,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Greedy random-swap search over permutations, on the precomputed cost.

    Returns ``perm`` such that audio column ``perm[k]`` is matched to video
    column ``k``.
    """
    k = cost.shape[0]
    if rng is None:
        rng = np.random.default_rng(0)
    best_perm = np.arange(k)
    best_cost = float(np.trace(cost))
    for _ in range(restarts):
        perm = np.arange(k)
        cur = np.array([cost[i, i] for i in range(k)], np.float64)
        last_improve = 0
        for it in range(steps):
            i, j = rng.choice(k, 2, replace=False)
            current = cur[i] + cur[j]
            future = cost[i, perm[j]] + cost[j, perm[i]]
            if current - future > 0:
                perm[i], perm[j] = perm[j], perm[i]
                cur[i] = cost[i, perm[i]]
                cur[j] = cost[j, perm[j]]
                last_improve = it
            if it - last_improve > patience:
                break
        total = float(cur.sum())
        if total < best_cost:
            best_cost = total
            best_perm = perm.copy()
    return best_perm


def match_order(
    logits_v: torch.Tensor,
    logits_a: torch.Tensor,
    rng: np.random.Generator | None = None,
    use_native: bool = True,
) -> np.ndarray:
    """Softmax both modalities, build C on the device, search on the host.
    Returns the permutation to apply to the audio head's output clusters.

    With ``use_native`` the search seeds the C++ loop with one draw from
    ``rng`` (``rng.integers(1, 2**62)``), as the JAX package does, so both
    leave ``rng`` in the same state; the draw is made even when the
    library is unavailable, and the Python loop then continues on ``rng``.
    Without it the Python loop runs on ``rng`` and nothing is drawn first.
    """
    pv = torch.softmax(logits_v.float(), dim=1)
    pa = torch.softmax(logits_a.float(), dim=1)
    cost = column_cost_matrix(pv, pa).cpu().numpy()
    if rng is None:
        rng = np.random.default_rng(0)
    if use_native:
        from selavi_tpu_torch import native

        perm = native.greedy_swap_match_native(
            cost, seed=int(rng.integers(1, 2 ** 62)))
        if perm is not None:
            return perm
    return greedy_swap_match(cost, rng=rng)
