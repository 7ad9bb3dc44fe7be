"""Target cluster-size marginals for Sinkhorn-Knopp.

The port's copy of ``selavi_tpu/selflabel/marginals.py`` (numpy only).

Reference semantics (reference src/sk_utils.py:366-394):

* ``distribution == 'default'``: uniform marginal, ``_K_dist = ones(K)``.
* ``distribution == 'gauss'``: per-cluster target sizes
  ``(randn(K) * gauss_sd + 1) * N / K``; a different draw per head when
  ``diff_dist_per_head`` (no clamping in that branch), otherwise one shared
  draw clamped to >= 1. Draws are cached across SK steps (and checkpointed,
  reference main.py:174,184,227) unless ``diff_dist_every``.
* sorting trick: the cached sizes are re-sorted each SK step so that the
  ranking of target sizes matches the ranking of current cluster masses
  (``_K_dist[argsort(PS.sum(0))] = sort(_K_dist)``) — reference
  sk_utils.py:368,388. The in-place assignment means the *cached* copy is
  sorted too; we reproduce that by storing the sorted version back.
* the SK column marginal is ``r = (1/_K_dist) / sum(1/_K_dist)``
  (sk_utils.py:392-394 — note the reciprocal; reproduced verbatim).

All of this is K-sized host math; kept in numpy for trivial checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MarginalState:
    """Cached per-head target-size vectors (the reference's ``args.dist``)."""

    dists: Optional[np.ndarray] = None  # [H, K] float64 or None

    def to_dict(self):
        return {"dists": None if self.dists is None else np.asarray(self.dists)}

    @classmethod
    def from_dict(cls, d):
        dists = d.get("dists")
        return cls(dists=None if dists is None else np.asarray(dists))


def get_marginal(
    state: MarginalState,
    ps_colsum: Optional[np.ndarray],
    head: int,
    headcount: int,
    n_samples: int,
    num_clusters: int,
    distribution: str = "default",
    gauss_sd: float = 0.1,
    diff_dist_every: bool = False,
    diff_dist_per_head: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, MarginalState]:
    """Return ``log r`` (length K, normalized) and the updated cache state."""
    k = num_clusters
    if distribution != "gauss":
        # 'default' — and any other choice (e.g. the reference CLI's 'zipf',
        # which its solver never implements: sk_utils.py:367-388 only
        # special-cases 'gauss', so anything else degenerates to uniform
        # sizes): ones.
        k_dist = np.ones((k,), np.float64)
    else:
        if rng is None:
            rng = np.random.default_rng(0)
        if state.dists is None or diff_dist_every:
            if diff_dist_per_head:
                dists = (
                    rng.standard_normal((headcount, k)) * gauss_sd + 1.0
                ) * (n_samples / k)
            else:
                shared = (
                    rng.standard_normal((k,)) * gauss_sd + 1.0
                ) * (n_samples / k)
                shared = np.clip(shared, 1.0, None)
                dists = np.tile(shared[None, :], (headcount, 1))
            state = MarginalState(dists=dists)
        k_dist = state.dists[head].copy()
        # sorting trick: target sizes track current cluster-mass ranks.
        if ps_colsum is not None:
            order = np.argsort(ps_colsum)
            k_dist[order] = np.sort(k_dist)
            new_dists = state.dists.copy()
            new_dists[head] = k_dist  # cache mutates, as in the reference
            state = MarginalState(dists=new_dists)

    r = 1.0 / k_dist
    r = r / r.sum()
    return np.log(r).astype(np.float32), state
