"""Milliseconds a batch of the program's span ``loader.collate`` (stack,
pinned pack and the enqueued copy to the card), over the batches
collated (the counter ``loader.batches``) in the traced steps."""

from benchmark import spans


def read(run):
    return spans.per_batch_ms(run, "loader.collate")
