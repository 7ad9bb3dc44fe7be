"""The reader of ``bn_act.device_ms``: the device time of the BatchNorm
kernels' instances (channels fastest and NCHW) in a traced SK step, and None where the program counted
no launch of it (a program without the kernel) or the run is no SK step."""

import pytest

from benchmark import harness
from selavi_tpu_torch.utils import profiling

KERNEL = ("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, false, "
          "false, true>((anonymous namespace)::Params)")
SUMMARY = {"busy_s": 4.0, "window_s": 4.3, "device_by_name": {
    KERNEL: [800, 0.5],
    KERNEL.replace("false, true>", "true, true>"): [384, 0.25],
    KERNEL.replace("bn_act_kernel<__nv_bfloat16, false,",
                   "bn_act_planar_kernel<__nv_bfloat16,"): [384, 0.0125],
    "void at::native::vectorized_elementwise_kernel<8, ...>": [10, 0.1]}}


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


def traced_run(driver, counters):
    profiling.totals.update({"engine.aggregate": [2, 4.0]})
    profiling.counters.update(counters)
    r = harness.Run(cell="x", seed=1, seconds=1.0, trace=True, config={},
                    workload={"driver": driver}, device="cpu")
    r.summary, r.traced_steps = SUMMARY, 1
    return r


def test_reads_the_kernels_device_ms():
    read = harness.reader("bn_act.device_ms")
    r = traced_run("selflabel", {"bn_act.launches": 1568})
    assert read(r) == pytest.approx(762.5)


@pytest.mark.parametrize("driver,counters", [
    ("selflabel", {}),                           # the parent's program
    ("pretrain", {"bn_act.launches": 10}),       # not an SK step
])
def test_reads_nothing_without_the_kernel(driver, counters):
    read = harness.reader("bn_act.device_ms")
    assert read(traced_run(driver, counters)) is None
