"""Seconds an SK step spends in the program's span
``engine.loader_start``: each aggregation pass's first wait for a batch,
which builds the eval loader, starts its workers and fills its first
prefetch; the traced SK step's sum over its passes."""

from benchmark import spans


def read(run):
    s = spans.of(run, "selflabel")
    if s is None or not run.traced_steps:
        return None
    total = spans.seconds(s[0], "engine.loader_start")
    return None if total is None else total / run.traced_steps
