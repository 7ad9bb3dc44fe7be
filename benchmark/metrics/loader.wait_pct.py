"""The share of the window spent in the benchmark's span around each
``next()`` on the Trainer's loader: the steps' wait for data, in %."""


def read(run):
    if run.traffic != "pretrain" or not run.window_s:
        return None
    return 100.0 * run.wait_s / run.window_s
