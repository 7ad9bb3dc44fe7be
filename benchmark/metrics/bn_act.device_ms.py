"""Device milliseconds a traced SK step in the eval-mode BatchNorm +
residual + ReLU kernels (``selavi_tpu_torch/csrc/bn_act.cu``): the device
time of every op whose name holds ``bn_act_kernel<`` or
``bn_act_planar_kernel<`` (each instance of either template: channels
fastest, and contiguous NCHW), over the traced SK step. It stands where ATen's eval BatchNorm
(``elementwise_kernel<128, 4, ...batch_norm_elementwise...>``), the ReLU
(``launch_clamp_scalar``) and the residual add (``CUDAFunctor_add``) were.
A run whose program did not count ``bn_act.launches`` in its traced part
has no such kernel and reads nothing."""

from benchmark import spans

FRAGMENTS = ("bn_act_kernel<", "bn_act_planar_kernel<")


def read(run):
    s = spans.of(run, "selflabel")
    if s is None or not s[1].get("bn_act.launches") or not run.traced_steps:
        return None
    total = sum(sec for name, (_, sec) in run.summary["device_by_name"].items()
                if any(f in name for f in FRAGMENTS))
    return 1e3 * total / run.traced_steps
