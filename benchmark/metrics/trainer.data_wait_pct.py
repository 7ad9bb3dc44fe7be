"""The share of the traced steps' wall time in which the Trainer waited
for its next device batch (the program's span ``trainer.data``: the
loader's ``next()`` and the wire decode), in %: the span's mean seconds
times the steps traced, over the traced wall seconds. The mean, since
the waits in which the profiler started and stopped are not recorded."""

from benchmark import spans


def read(run):
    s = spans.of(run, "pretrain")
    if s is None or not run.traced_wall_s:
        return None
    mean = spans.mean_s(s[0], "trainer.data")
    if mean is None:
        return None
    return 100.0 * mean * run.traced_steps / run.traced_wall_s
