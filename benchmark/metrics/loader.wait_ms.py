"""Milliseconds a batch of the program's span ``loader.wait`` (the
consumer blocked on a batch's examples from the render workers), over the
batches collated (the counter ``loader.batches``) in the traced steps."""

from benchmark import spans


def read(run):
    return spans.per_batch_ms(run, "loader.wait")
