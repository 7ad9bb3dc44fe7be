"""The share of the traced training steps in which no device interval
runs, in %."""


def read(run):
    if run.traffic != "pretrain" or run.summary is None:
        return None
    s = run.summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
