"""The program's spans and counters in the traced part of a run: the
``totals`` {name: [count, seconds]} and ``counters`` {name: count} that
``selavi_tpu_torch/utils/profiling.py`` keeps while a ``torch.profiler``
session records, which in a run of the benchmark is the ``Tracer``'s
alone. A span that the ``Tracer``'s start or stop cut is in neither.

A program without the span layer, or one that recorded nothing, gives
None, and so does every reader built on this module.
"""

from __future__ import annotations


def of(run, traffic):
    """``(totals, counters)`` of a traced run of a driver of ``traffic``
    (``Run.traffic``), or None; the totals and counters are also put in
    ``run.extra`` (printed as ``reading`` lines)."""
    if run.traffic != traffic or not run.summary:
        return None
    try:
        from selavi_tpu_torch.utils import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if not totals:
        return None
    counters = getattr(profiling, "counters", {})
    run.extra["spans.totals"] = {k: list(v) for k, v in totals.items()}
    run.extra["spans.counters"] = dict(counters)
    return totals, counters


def seconds(totals, name):
    """The total seconds of span ``name``, or None."""
    total = totals.get(name)
    return total[1] if total and total[0] else None


def mean_s(totals, name):
    """The mean seconds of span ``name``, or None."""
    total = totals.get(name)
    return total[1] / total[0] if total and total[0] else None


def per_batch_ms(run, name):
    """Milliseconds of span ``name`` a batch collated (the counter
    ``loader.batches``) in a traced pretraining run, or None."""
    s = of(run, "pretrain")
    if s is None:
        return None
    totals, counters = s
    total = seconds(totals, name)
    batches = counters.get("loader.batches")
    if total is None or not batches:
        return None
    return 1e3 * total / batches
