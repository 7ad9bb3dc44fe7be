"""The benchmark's driver-independent part: finding a cell's files by
name, the record a run fills in, the metrics read from it, the guard
against JAX, and the result line.

A cell ``<name>`` of ``BENCHMARK.json`` is driven by the data file
``workloads/<name>.json``, whose ``driver`` names ``traffic/<driver>.py``;
its configuration is the file that ``BENCHMARK.json`` gives, whose
towers are found by name (``reference/towers``); every metric
``<metric>`` is read by ``metrics/<metric>.py`` (a function ``read(run)``
that returns a number, or None where the run holds nothing to read). A
driver module's ``TRAFFIC`` says what it drives (``"pretrain"`` or
``"selflabel"``), and the readers take or leave a run by that
(``Run.traffic``), never by the driver's name. Nothing here needs an
edit when a cell, a configuration, a tower, a driver or a metric is
added.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that a run may not load (the JAX package's own
# name is a prefix of the port's: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "selavi_tpu")


@dataclasses.dataclass
class Run:
    """What one run of one cell measured and checked."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    workload: dict
    device: str = "cuda"
    cache: Path = HERE / ".cache"
    t0: float = 0.0
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    units: int = 0  # clips trained, or SK steps
    wait_s: float = 0.0  # the benchmark's spans around the loader's next()
    memory_peak_bytes: int = 0  # the process's peak before the check
    window_peak_bytes: int = 0  # the peak inside the window
    summary: Optional[dict] = None  # trace.summarize of the traced part
    traced_steps: int = 0
    traced_units: int = 0
    traced_wall_s: Optional[float] = None
    timings: list = dataclasses.field(default_factory=list)
    flops: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)  # name: (x, lim)

    @property
    def traffic(self):
        """The ``TRAFFIC`` of the cell's driver, or None."""
        return getattr(driver(self.workload), "TRAFFIC", None)

    @property
    def correct(self):
        return bool(self.checks) and all(
            x == x and x <= lim for x, lim in self.checks.values())


def spec(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(bench, cell):
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def load_cell(bench, cell, root=ROOT):
    """``(entry, config, workload)`` of ``cell``."""
    entry = cell_entry(bench, cell)
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(Path(root) / cfg["file"]) as f:
        config = json.load(f)
    with open(Path(root) / "benchmark" / "workloads" / f"{cell}.json") as f:
        workload = json.load(f)
    return entry, config, workload


def driver(workload):
    return importlib.import_module(f"benchmark.traffic.{workload['driver']}")


def reader(metric, root=ROOT):
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    loaded = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module.read


def metrics_of(bench, cell, traced):
    """The metrics a run of ``cell`` reports: its end-to-end ones, or
    with ``traced`` its per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(bench, run, root=ROOT):
    out = {}
    for m in metrics_of(bench, run.cell, run.trace):
        value = reader(m["name"], root)(run)
        if value is None:
            if not run.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def result(run, metrics, device):
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.summary:
        line["breakdown"] = {"device_ops": run.summary["device_ops"],
                             "idle_gaps": run.summary["idle_gaps"]}
    line["checks"] = {k: {"value": x, "limit": lim}
                      for k, (x, lim) in run.checks.items()}
    return line
