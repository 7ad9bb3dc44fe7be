"""Model FLOPs utilisation of the traced steps, in %: the model FLOPs of
a training clip (``flops.clip_flops``: forward, input and weight
gradients, nothing recomputed) times the clips trained, over the traced
span's wall seconds, over the card's bf16 peak."""

from benchmark.flops import BF16_PEAK_FLOPS


def read(run):
    if (run.traffic != "pretrain" or run.summary is None
            or not run.traced_wall_s):
        return None
    return (100.0 * run.flops["train"] * run.traced_units
            / run.traced_wall_s / BF16_PEAK_FLOPS)
