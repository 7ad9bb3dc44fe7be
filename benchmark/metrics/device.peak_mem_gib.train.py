"""The card's peak allocated memory in the window, in GiB
(``max_memory_allocated`` after a reset at the window's start)."""


def read(run):
    if run.traffic != "pretrain" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
