"""Run one cell of the benchmark of ``selavi_tpu_torch`` on the card(s) of
this machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload vggsound-pretrain --seed 1234 \
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (read from a ``torch.profiler`` trace of part of the
window and the benchmark's own spans) with the device's busy time and a
breakdown. Every run checks what its timed path produced against the
plain reference in ``benchmark/reference`` and prints each number it
compared beside its limit, last on standard error and last in the result.
Exits 2 without a result when the cell's cards are not there, and 3 when
the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# build and kernel caches at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(CACHE / _dir))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.spec(ROOT)
    entry, config, workload = harness.load_cell(bench, a.workload, ROOT)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"{a.workload} needs {entry['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = harness.Run(cell=a.workload, seed=a.seed, seconds=a.seconds,
                      trace=bool(a.trace), config=config, workload=workload,
                      cache=CACHE, t0=T0)
    harness.driver(workload).run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark and the port may "
              f"not import JAX or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace:
        device["busy_s"] = run.summary["busy_s"]
        device["window_s"] = run.summary["window_s"]
    metrics = harness.read_metrics(bench, run, ROOT)
    line = harness.result(run, metrics, device)
    for name, value in run.extra.items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    for name, (x, lim) in run.checks.items():
        print(f"check {name} {x!r} limit {lim!r}", file=sys.stderr)
    print(f"correct {run.correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
