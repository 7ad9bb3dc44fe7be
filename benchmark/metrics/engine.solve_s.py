"""Seconds of an SK step's Sinkhorn-Knopp solves over all heads (the
engine's ``timings["solve_s"]``), the mean over the window's SK steps."""


def read(run):
    values = [t["solve_s"] for t in run.timings if "solve_s" in t]
    return sum(values) / len(values) if values else None
