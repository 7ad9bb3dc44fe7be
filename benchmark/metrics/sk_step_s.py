"""The window's seconds over the whole SK steps it holds (the host
clock)."""


def read(run):
    if run.traffic != "selflabel" or not run.units:
        return None
    return run.window_s / run.units
