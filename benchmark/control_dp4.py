"""The readings that the limits of a ``pretrain_dp4`` cell's ``correct`` are
set from, on its ranks, one card each, at the cell's own size: each held
to the float32 reference at the global batch (``pretrain_dp4``'s check) by
``compare.training`` and judged under the workload file's limits, as a
run is.

- ``port``: the port's first steps, as the cell's runs train them;
- ``fault_local_bn``: the same with the all-reduces of the port's
  ``GlobalBatchNorm`` left out, so that each rank normalises by the
  statistics of its own rows (the exchange between the cards that the
  cell exists to hold);
- ``control_fp8``: the reference in the port's place, its products
  computed in float8 (``reference.model.Precision.fp8``) at the global
  batch.

The port's two also read ``bn_rank_gap`` (``pretrain_dp4.bn_rank_gap``:
how far the ranks' BatchNorm running statistics lie apart after the
steps); ``--no-references`` reads that alone, without the references.

    python3 benchmark/control_dp4.py --workload vggsound-pretrain-dp4 \\
        --seeds 11 12 13

Rank 0 is this process and starts the other ranks as processes of this
module. Prints one JSON line a seed and reading: ``{"seed", "reading",
"correct", "checks", "readings"}``. The benchmark's runs do not run this.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import compare, data, harness, system  # noqa: E402
from benchmark.control import judge  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.traffic import pretrain_dp4 as dp  # noqa: E402


@contextlib.contextmanager
def local_batchnorm():
    """The port's ``GlobalBatchNorm`` with its all-reduces left out: the
    statistics, and the backward's sums, of this rank's rows alone."""
    from selavi_tpu_torch.models import common

    saved = common.tdist
    common.tdist = types.SimpleNamespace(
        is_initialized=saved.is_initialized,
        get_world_size=saved.get_world_size,
        all_reduce=lambda *a, **k: None)
    try:
        yield
    finally:
        common.tdist = saved


@contextlib.contextmanager
def fp8():
    ref_model.Precision.fp8 = True
    try:
        yield
    finally:
        ref_model.Precision.fp8 = False


def port_steps(r, local_bn=False):
    """The port's first steps on this rank: ``(losses, first, last)``,
    the ranks' ``bn_rank_gap`` after them, and the run's ``(state,
    labels, shard, args)``."""
    trainer, state, labels, shard = system.build(r)
    args = trainer.args
    with local_batchnorm() if local_bn else contextlib.nullcontext():
        feed, losses, first, last = dp.warm_steps(trainer, r)
    spread = dp.bn_rank_gap(trainer.model)
    feed.close()
    del trainer, feed
    system.free()
    return (losses, first, last), spread, (state, labels, shard, args)


def readings_of(r, rank, ranks, references=True):
    """The seed's readings, each against the float32 reference; on rank
    0 a dict ``{reading: (readings)}``, on the others None."""
    port, spread, (state, labels, shard, args) = port_steps(r)
    fault, fault_spread, _ = port_steps(r, local_bn=True)
    out = {"port": {"bn_rank_gap": spread},
           "fault_local_bn": {"bn_rank_gap": fault_spread}}
    if references:
        steps = len(port[0])
        ref = dp.reference_steps(r, shard, state, labels, args, steps, rank,
                                 ranks)
        system.free()
        with fp8():
            ctl = dp.reference_steps(r, shard, state, labels, args, steps,
                                     rank, ranks)
        system.free()
        for name, other in (("port", port), ("fault_local_bn", fault),
                            ("control_fp8", ctl)):
            readings, where = compare.training(*other, *ref, state, args.wd)
            out.setdefault(name, {}).update(readings, **where)
    return out if rank == 0 else None


def rank_main(spec, rank):
    ranks = spec["ranks"]
    r = harness.Run(cell=spec["cell"], seed=spec["seeds"][0], seconds=0,
                    trace=False, config=spec["config"],
                    workload=spec["workload"], device=spec["device"],
                    cache=Path(spec["cache"]), t0=time.perf_counter())
    dp.join(r, rank, ranks, spec["port"])
    for seed in spec["seeds"]:
        r.seed = seed
        out = readings_of(r, rank, ranks, spec["references"])
        for name, readings in (out or {}).items():
            correct, checks = judge(readings, r.workload["limits"])
            print(json.dumps({"seed": seed, "reading": name,
                              "correct": correct, "checks": checks,
                              "readings": readings}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def run(cell, seeds, config, workload, device, cache, references=True):
    """Rank 0's part: start the other ranks, run, wait for them."""
    ranks = workload.get("ranks", 4)
    data.shard_path(config, cache)  # built once, before any rank reads it
    work = Path(tempfile.mkdtemp(prefix="portbench_dpctl_"))
    spec = {"cell": cell, "seeds": seeds, "device": device,
            "cache": str(cache), "config": config, "workload": workload,
            "port": dp._free_port(), "ranks": ranks,
            "references": references}
    (work / "run.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for k in range(1, ranks):
        log = open(work / f"rank{k}.log", "w")
        procs.append((k, log, subprocess.Popen(
            [sys.executable, "-m", "benchmark.control_dp4", "--rank",
             str(k), "--work", str(work)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    threading.Thread(target=dp._watch, args=(procs,), daemon=True).start()
    try:
        rank_main(spec, 0)
    except BaseException:
        for _, _, p in procs:
            p.kill()
        raise
    finally:
        codes = dp._join(procs)
    if codes:
        raise RuntimeError(f"ranks failed: exit codes {codes}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--no-references", action="store_true",
                   help="the ranks' BatchNorm buffers alone")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--work", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.rank is not None:  # a rank that rank 0 started
        threading.Thread(target=dp._parent_watch, args=(os.getppid(),),
                         daemon=True).start()
        rank_main(json.loads((Path(a.work) / "run.json").read_text()),
                  a.rank)
        return 0
    if not (a.workload and a.seeds):
        p.error("--workload and --seeds are required")
    if not torch.cuda.is_available():
        print("the control runs on the cards", file=sys.stderr)
        return 2
    bench = harness.spec(ROOT)
    _, config, workload = harness.load_cell(bench, a.workload, ROOT)
    run(a.workload, a.seeds, config, workload, "cuda",
        ROOT / "benchmark" / ".cache", references=not a.no_references)
    return 0


if __name__ == "__main__":
    sys.exit(main())
