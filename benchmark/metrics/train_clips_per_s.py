"""Clips trained in the window over the window's seconds (the host
clock, from the window's start to the synchronisation after its last
step), loader stalls included."""


def read(run):
    if run.traffic != "pretrain" or not run.window_s:
        return None
    return run.units / run.window_s
