"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: the reference put in the system's place, computed in
float8 (the control), the faults planted in it and, for training, the
reference under bf16 autocast, each against the float32 reference, on the
given seeds, and each held to the limits of the cell's workload file as a
run is. The system's own readings are those that the benchmark's runs
print.

    python3 benchmark/control.py --workload vggsound-pretrain \
        --seeds 11 12 13

Prints one JSON line a seed and reading: ``{"seed", "reading", "correct",
"checks", "readings"}``, where ``checks`` holds each limited number that
the reading has beside its limit and ``correct`` is false where one of
them is over it. The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def inputs(r):
    """A run's ``system.inputs`` and its configuration as an
    ``args``-like namespace."""
    from benchmark import system

    return (*system.inputs(r), types.SimpleNamespace(**r.config))


def training_readings(r, faults=True, look=True):
    from benchmark import compare
    from benchmark.traffic.pretrain import reference_steps

    state, labels, shard, args = inputs(r)
    steps = r.workload["warm_steps"]
    ref = reference_steps(r, shard, state, labels, args, steps)
    out = {}
    variants = {"control_fp8": {"fp8": True}}
    if faults:
        variants["fault_half_batch"] = {"keep_rows": args.batch_size // 2}
    if look:  # a second implementation at the system's precision
        variants["reference_bf16"] = {"bf16": True}
    for name, kw in variants.items():
        other = reference_steps(r, shard, state, labels, args, steps, **kw)
        readings, where = compare.training(*other, *ref, state, args.wd)
        out[name] = dict(readings, **where)
    return out


def selflabel_readings(r, faults=True, look=False):
    from benchmark.reference import train as ref_train
    from benchmark.traffic.selflabel import cluster_sizes, reference_step

    state, labels, shard, args = inputs(r)
    n = r.config[r.workload["samples"]]
    sizes = cluster_sizes(r.seed, args.headcount, args.mlp_dim, n,
                          args.gauss_sd)
    count = 2 * args.ind_groups  # the last pass of the window's first step
    ref = reference_step(r, shard, state, args, sizes, count)
    ctl = reference_step(r, shard, state, args, sizes, count, fp8=True)
    ref_cost = float(np.mean([c for _, _, c in ref]))
    ctl_cost = float(np.mean([c for _, _, c in ctl]))
    gap = max(ref_train.label_gap(score, c_labels)
              for (_, score, _), (c_labels, _, _) in zip(ref, ctl))
    out = {"control_fp8": {"label_gap": gap,
                           "cost_gap": abs(ctl_cost - ref_cost) / ref_cost}}
    if faults:  # one label altered where it is produced
        labels0 = ref[0][0].clone()
        labels0[0] = ref[0][1][0].argmin()
        out["fault_one_label"] = {"label_gap": ref_train.label_gap(
            ref[0][1], labels0)}
    return out


READINGS = {"pretrain": training_readings, "selflabel": selflabel_readings}


def judge(readings, limits):
    """``(correct, checks)``: the readings that ``limits`` names, each
    beside its limit, and whether all of them lie within it, as a run's
    ``correct`` is decided. A reading that a variant does not have is
    not checked."""
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in limits.items() if k in readings}
    correct = bool(checks) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-only", action="store_true",
                   help="the float8 control alone: no faults, no look")
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.spec(ROOT)
    _, config, workload = harness.load_cell(bench, a.workload, ROOT)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        r = harness.Run(cell=a.workload, seed=seed, seconds=0, trace=False,
                        config=config, workload=workload)
        only = {"faults": False, "look": False} if a.control_only else {}
        for name, readings in READINGS[r.traffic](r, **only).items():
            correct, checks = judge(readings, workload["limits"])
            print(json.dumps({"seed": seed, "reading": name,
                              "correct": correct, "checks": checks,
                              "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
