"""A tiny copy of a cell for the CPU tests: the real configuration's
widths with few frames, small crops, two heads of 16 clusters and a
handful of samples, computed in float32."""

import json
import time
from pathlib import Path

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]

TINY = dict(num_frames=4, train_crop_size=32, stored_size=48, headcount=2,
            mlp_dim=16, batch_size=4, sk_agg_batch=4, workers=2,
            compute_dtype="float32", base_lr=0.001, dataset_samples=64,
            distinct_samples=8, sk_step_samples=12, aud_sample_rate=16000)
# at this size (fp32 on both sides) the port reads at most 1e-5 on the
# first gradient and 0.011 on the median leaf's change after three steps
# (the towers' BatchNorm amplifies round-off, more at lr 1e-3 than 0);
# the fp8 control reads 0.005-0.036 on the heads' last layer and 0.03-0.08
# on the median leaf's gradient, the faults 0.09 and more
LIMITS = {"grad_gap_median": 5e-3, "change_gap_median": 0.05,
          "proj_bias_gap": 1e-3, "proj_weight_gap": 1e-3,
          "proj_weight_gap_v": 1e-3, "proj_bias_gap_a": 1e-3,
          "label_gap": 1e-3, "cost_gap": 1e-4}


def run(cell, cache, seed=2 ** 31 + 12345, seconds=2.0, trace=False,
        config="vggsound-r2p1d18-resnet9"):
    """A tiny run of ``cell`` on the CPU, through its driver."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg.update(TINY)
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    wl["trace_steps"] = 2
    wl["limits"] = {k: LIMITS[k] for k in wl["limits"]}
    r = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                    config=cfg, workload=wl, device="cpu", cache=cache,
                    t0=time.perf_counter())
    harness.driver(wl).run(r)
    return r
