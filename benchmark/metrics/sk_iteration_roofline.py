"""The fused SK kernel's share of its roofline, in %: the bytes one
iteration needs at the cell's [N, K] in fp32 (``flops.sk_iteration_bytes``)
over the HBM peak, over the kernel's mean duration in the trace. It is
bound by bytes."""

from benchmark.flops import HBM_BYTES_PER_S, sk_iteration_bytes
from benchmark.trace import mean_duration


def read(run):
    if run.traffic != "selflabel" or run.summary is None:
        return None
    seconds = mean_duration(run.summary, "sk_iteration")
    if not seconds:
        return None
    least = (sk_iteration_bytes(run.extra["n"], run.extra["k"])
             / HBM_BYTES_PER_S)
    return 100.0 * least / seconds
