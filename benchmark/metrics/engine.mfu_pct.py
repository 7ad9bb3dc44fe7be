"""Model FLOPs utilisation of the SK steps, in %: the forward FLOPs of a
clip times the N clips of each of a step's aggregation passes (one a
group of heads) times the steps, over the window's seconds, over the
card's bf16 peak."""

from benchmark.flops import BF16_PEAK_FLOPS


def read(run):
    if run.traffic != "selflabel" or not run.units:
        return None
    clips = run.extra["n"] * run.extra["passes"]
    work = run.flops["forward"] * clips * run.units
    return 100.0 * work / run.window_s / BF16_PEAK_FLOPS
