"""Seconds of an SK step's feature aggregation (the engine's
``timings["aggregate_s"]``), the mean over the window's SK steps."""


def read(run):
    values = [t["aggregate_s"] for t in run.timings if "aggregate_s" in t]
    return sum(values) / len(values) if values else None
