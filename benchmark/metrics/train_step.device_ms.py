"""Device milliseconds a train step: the union of the device's
intervals (kernels, copies, fills) in the trace over the steps traced."""


def read(run):
    if (run.traffic != "pretrain" or run.summary is None
            or not run.traced_steps):
        return None
    return 1e3 * run.summary["busy_s"] / run.traced_steps
