"""Power-law Sinkhorn-Knopp re-clustering schedule.

The port's copy of ``selavi_tpu/selflabel/schedule.py`` (numpy only).

Reference (reference main.py:163-171,189-197): ``nopts`` SK steps are
spread over all training iterations at positions
``epochs * N_dl * (linspace(0,1,nopts) ** power)[::-1]`` — dense early,
sparse late. A never-reached sentinel ``(epochs+2)*N_dl`` is prepended so the
list is never exhausted. A step fires when
``batches_thusfar + it >= schedule[-1]`` and is popped. On resume the
schedule is recomputed and entries before the restored epoch are dropped.
"""

from __future__ import annotations

import numpy as np


def make_sk_schedule(
    epochs: int, batches_per_epoch: int, nopts: int, power: float = 1.5
) -> list[float]:
    sched = (
        epochs
        * batches_per_epoch
        * (np.linspace(0, 1, nopts) ** power)[::-1]
    ).tolist()
    return [(epochs + 2) * batches_per_epoch] + sched


def fast_forward_schedule(
    schedule: list[float], batches_per_epoch: int, start_epoch: int
) -> tuple[list[float], int]:
    """Drop entries already consumed before ``start_epoch``.

    Returns (remaining schedule, number of SK steps already performed) —
    mirrors the reference main.py:189-195.
    """
    include = [(q / batches_per_epoch > start_epoch) for q in schedule]
    done = len(schedule) - sum(include)
    remaining = [q for q, keep in zip(schedule, include) if keep]
    return remaining, done
