"""Seconds from the process's start to the first timed step (the host
clock): imports, the shard, the model and its weights, the warm-up."""


def read(run):
    return run.setup_s
