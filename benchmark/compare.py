"""The numbers that decide ``correct``: how far what the timed path
produced lies from what the plain reference works out from the same
inputs.

Training: each step's loss, the first gradient as the optimizer got it
(its momentum buffer after one step) and the parameters' change after the
first steps, the last two leaf by leaf: the gap between the two sides'
norms of a leaf, over the reference's norm of that leaf or of the median
leaf, whichever is larger, taken at the worst leaf, at the median leaf,
and at the heads' last dense layer. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change.

Self-labeling: the widest gap by which a label the system chose lies below
the reference's best score of its row, and the SK cost's relative gap.

A cell compares the readings its workload file gives a limit; the others
are printed beside them.
"""

from __future__ import annotations

import torch

SMALL_GRADIENT = 1e-3  # of the median leaf's reference gradient


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gaps(system, reference, names):
    """``{leaf: | |s| - |r| | / max(|r|, median |r|)}`` over ``names``."""
    s, r = _norms({k: system[k] for k in names}), _norms(
        {k: reference[k] for k in names})
    median = sorted(r.values())[len(r) // 2]
    return {k: abs(s[k] - r[k]) / max(r[k], median, 1e-30) for k in names}


def leaf_diffs(system, reference, names):
    """``{leaf: |s - r| / max(|r|, median |r|)}`` over ``names``: the norm
    of the difference, which moves with the first power of a rounding
    error where a gap of norms moves with its square."""
    r = _norms({k: reference[k] for k in names})
    d = _norms({k: system[k] - reference[k] for k in names})
    median = sorted(r.values())[len(r) // 2]
    return {k: d[k] / max(r[k], median, 1e-30) for k in names}


def moving_leaves(first_buffers, start, wd):
    """The leaves whose reference gradient (the first buffer less the
    decay ``wd * p0``) is at least ``SMALL_GRADIENT`` of the median's."""
    g = _norms({k: first_buffers[k] - wd * start[k] for k in first_buffers})
    median = sorted(g.values())[len(g) // 2]
    return [k for k, v in g.items() if v >= SMALL_GRADIENT * median]


def _worst(gaps, n=3):
    return [[k, gaps[k]] for k in sorted(gaps, key=gaps.get)[::-1][:n]]


def _median(gaps):
    return sorted(gaps.values())[len(gaps) // 2]


def training(sys_losses, sys_first, sys_last, ref_losses, ref_first,
             ref_last, start, wd):
    """The readings of a training run against the reference, and where
    they lie: ``loss_gap`` (the largest over the steps); ``grad_gap`` and
    ``change_gap`` (the worst leaf) and their medians over the leaves;
    ``grad_diff_median`` (the median leaf's norm of the difference);
    ``proj_bias_gap`` and ``proj_weight_gap`` (the worse of the two head
    stacks' last dense layer, first gradient)."""
    names = sorted(ref_first)
    gaps = [abs(a - b) for a, b in zip(sys_losses, ref_losses)]
    loss_gap = max(gaps) if len(sys_losses) == len(ref_losses) else (
        float("inf"))
    grad = leaf_gaps(sys_first, ref_first, names)
    moving = moving_leaves(ref_first, start, wd)
    change = lambda last: {k: last[k] - start[k] for k in moving}
    moved = leaf_gaps(change(sys_last), change(ref_last), moving)
    readings = {"loss_gap": loss_gap,
                "grad_gap": max(grad.values()),
                "change_gap": max(moved.values()),
                "grad_gap_median": _median(grad),
                "change_gap_median": _median(moved),
                "grad_diff_median": _median(
                    leaf_diffs(sys_first, ref_first, names))}
    for leaf in ("proj_bias", "proj_weight"):
        for m in ("v", "a"):
            readings[f"{leaf}_gap_{m}"] = grad[f"heads_{m}.{leaf}"]
        readings[f"{leaf}_gap"] = max(readings[f"{leaf}_gap_v"],
                                      readings[f"{leaf}_gap_a"])
    return readings, {"grad_worst": _worst(grad),
                      "change_worst": _worst(moved),
                      "leaves_moving": len(moving), "leaves": len(names)}
