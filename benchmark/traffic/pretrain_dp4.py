"""Pretraining traffic on four ranks, one card each: ``Trainer.train_epoch``
under ``DistributedDataParallel`` with the port's global BatchNorm, each
rank a batch of the configuration's ``batch_size`` from its stride of the
epoch's order, so that a step trains the global batch of ``ranks`` times
that.

Rank 0 is the process that ``benchmark/run.py`` started; it builds the
shard, then starts ranks 1 to ``ranks - 1`` as processes of this module
(``--rank``), which join the process group through the port's
``parallel/dist.py::init_distributed_mode`` (NCCL on the card, its
shared-memory transport off; gloo on the CPU) and print no result. Every
rank: the Trainer with the benchmark's weights and labels, the BN warm-up,
the first steps (``warm_steps``), then two steps timed for the budget:
the slowest rank's step time, agreed in one all-reduce before the window,
sets the one number of steps that every rank runs in the window,
``--seconds`` over it, so that no rank waits at a collective that another
will not reach and no collective is added to a step. No SK step and no
checkpoint falls inside the window.

What the run reports: ``units`` counts the clips of all ranks (the job's
rate); the traced part (``--trace 1``: ``trace_steps`` steps from window
step ``trace_from``), its spans, clips and seconds, and the memory peaks
are rank 0's alone, so the per-layer metrics read one card.

The check: after the window every rank trains the plain reference's first
steps on its rows of the global batch, from the same weights, on the same
samples, crops, flips and dropout masks (each the global batch's draw, of
which a rank keeps rows ``rank::ranks``), with BatchNorm's statistics over
the global batch (the reference's ``batch_norm`` with its sums added over
the ranks by an all-reduce whose gradient is the all-reduce of the
gradients) and the gradients averaged over the ranks before each SGD
update: the one-process step at the global batch, a quarter of it on each
card, since the reference at 512 clips does not fit on one. Rank 0
compares (``compare.training``) under the cell's limits, beside
``bn_rank_gap``: how far the ranks' BatchNorm running statistics lie
apart after the window, which the global batch's statistics keep equal
(one all-reduce, after the window).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchmark import compare, data, flops, harness, system
from benchmark.reference import inputs as ref_inputs
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.weights import load_into

TRAFFIC = "pretrain"  # what the readers of a run take it for (harness)
ROOT = Path(__file__).resolve().parents[2]
TIMED_STEPS = 2  # steps timed after the warm steps, for the window's budget
JOIN_S = 600.0  # the most that rank 0 waits for the other ranks to exit


def run(r):
    ranks = r.workload.get("ranks", 4)
    data.shard_path(r.config, r.cache)  # built once, before any rank reads it
    work = Path(tempfile.mkdtemp(prefix="portbench_dp_"))
    spec = {"cell": r.cell, "seed": r.seed, "seconds": r.seconds,
            "device": r.device, "cache": str(r.cache), "config": r.config,
            "workload": r.workload, "port": _free_port(), "ranks": ranks}
    (work / "run.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for k in range(1, ranks):
        log = open(work / f"rank{k}.log", "w")
        procs.append((k, log, subprocess.Popen(
            [sys.executable, "-m", "benchmark.traffic.pretrain_dp4",
             "--rank", str(k), "--work", str(work)], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT)))
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        steps = rank_run(r, 0, ranks, spec["port"])
    except BaseException:
        for _, _, p in procs:  # they would wait at rank 0's collectives
            p.kill()
        raise
    finally:
        codes = _join(procs)
    others = [json.loads((work / f"rank{k}.json").read_text())["steps"]
              for k in range(1, ranks)]
    r.extra["rank_steps"] = [steps] + others
    if codes or any(s != steps for s in others):
        raise RuntimeError(f"ranks ended apart: exit codes {codes}, window "
                           f"steps {r.extra['rank_steps']}")


def rank_run(r, rank, ranks, port):
    """One rank's whole run; returns its window steps. Rank 0 fills ``r``."""
    split = {"imports": time.perf_counter() - r.t0}
    join(r, rank, ranks, port)
    trainer, state, labels, shard = system.build(r)
    args = trainer.args
    split["build"] = time.perf_counter() - r.t0 - sum(split.values())
    feed, losses, first, last = warm_steps(trainer, r)
    budget = _budget(trainer, feed, r)
    r.setup_s = time.perf_counter() - r.t0
    split["warm_up"] = r.setup_s - sum(split.values())
    r.extra["setup_split"] = split
    r.extra["window_budget_steps"] = budget
    setup_peak = system.peak(r.device)

    system.reset_peak(r.device)
    tracer = system.Tracer(r.device) if r.trace and rank == 0 else None
    start_at = feed.served + r.workload["trace_from"]
    traced = {}

    def on_batch(k):
        if tracer is None:
            return
        if k == start_at and tracer.prof is None and tracer.wall_s is None:
            tracer.start()
            traced["from"] = k
        elif k == start_at + r.workload["trace_steps"] and tracer.on:
            tracer.stop()
            traced["to"] = k

    feed.on_batch = on_batch
    feed.budget, feed.wait_s = budget, 0.0
    first_window_batch = feed.served
    t = time.perf_counter()
    trainer.train_epoch(0)
    system.synchronize(r.device)
    r.window_s = time.perf_counter() - t
    if tracer is not None and tracer.on:
        tracer.stop()
        traced["to"] = feed.served
    steps = feed.served - first_window_batch
    r.attempted, r.failed = steps, 0
    r.units = steps * args.batch_size * ranks
    r.wait_s = feed.wait_s
    r.window_peak_bytes = system.peak(r.device)
    r.memory_peak_bytes = max(setup_peak, r.window_peak_bytes)
    r.flops = flops.clip_flops(args.__dict__, flops.spec_frames(
        args.num_sec_aud, args.aud_sample_rate))
    if tracer is not None and tracer.summary is not None:
        r.summary = tracer.summary
        r.traced_wall_s = tracer.wall_s
        r.traced_steps = traced["to"] - traced["from"]
        r.traced_units = r.traced_steps * args.batch_size
    feed.close()
    spread = bn_rank_gap(trainer.model)
    del trainer, feed
    system.free()

    ref_losses, ref_first, ref_last = reference_steps(
        r, shard, state, labels, args, len(losses), rank, ranks)
    if rank == 0:
        readings, where = compare.training(losses, first, last, ref_losses,
                                           ref_first, ref_last, state,
                                           args.wd)
        readings["bn_rank_gap"] = spread
        r.extra.update(where, readings=readings, losses=losses,
                       ref_losses=ref_losses)
        r.checks = {k: (readings[k], lim)
                    for k, lim in r.workload["limits"].items()}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return steps


def join(r, rank, ranks, port):
    """Join the process group as ``rank`` of ``ranks`` through the port's
    ``init_distributed_mode``; on the card ``r.device`` becomes the
    rank's own."""
    from selavi_tpu_torch.parallel.dist import init_distributed_mode

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(ranks), RANK=str(rank),
                      LOCAL_RANK=str(rank), NCCL_SHM_DISABLE="1")
    init_distributed_mode(None, r.device)
    if torch.device(r.device).type == "cuda":
        r.device = f"cuda:{rank}"


def warm_steps(trainer, r):
    """The BN warm-up and the ``warm_steps`` first steps that the check
    reads: ``(feed, losses, first momentum buffers, last parameters)``,
    the Trainer's loader replaced by ``feed``."""
    trainer.sk_schedule = [math.inf]  # no SK step in the window
    trainer.warmup_batchnorm(r.config["bn_warmup_batches"])
    feed = system.Feed(trainer.loader)
    trainer.loader = feed
    names = [n for n, _ in trainer.model.named_parameters()]
    params = [p for _, p in trainer.model.named_parameters()]
    losses, first = [], None
    for _ in range(r.workload["warm_steps"]):
        feed.budget = 1
        trainer.train_epoch(0)
        losses.append(trainer.history[-1]["loss"])
        if first is None:  # a leaf the step never moved has no buffer
            first = {n: trainer.optimizer.state[p].get(
                "momentum_buffer", torch.zeros_like(p)).clone()
                for n, p in zip(names, params)}
    last = {n: p.detach().clone() for n, p in zip(names, params)}
    return feed, losses, first, last


def bn_rank_gap(model):
    """How far the ranks' BatchNorm running statistics lie apart: the
    largest, over the ``running_mean`` and ``running_var`` buffers, of the
    norm of their spread over the ranks (largest less least, element by
    element) over the norm of this rank's buffer. The port normalises
    every rank by the global batch's statistics and leaves the buffers
    alone in DDP's forward, so they stay equal on every rank (0);
    statistics of each rank's own rows part them. One all-reduce, after
    the steps, on every rank."""
    bufs = [b.detach().double().reshape(-1)
            for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]
    flat = torch.cat(bufs)
    both = torch.cat([flat, -flat])
    torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX)
    spread = (both[:flat.numel()] + both[flat.numel():]).split(
        [b.numel() for b in bufs])
    return max(float(d.norm() / b.norm().clamp_min(1e-30))
               for d, b in zip(spread, bufs))


def _budget(trainer, feed, r):
    """The window's steps: ``--seconds`` over the slowest rank's mean time
    of ``TIMED_STEPS`` steps, agreed by one MAX all-reduce."""
    system.synchronize(r.device)
    t = time.perf_counter()
    for _ in range(TIMED_STEPS):
        feed.budget = 1
        trainer.train_epoch(0)
    system.synchronize(r.device)
    step_s = torch.tensor([(time.perf_counter() - t) / TIMED_STEPS],
                          dtype=torch.float64, device=r.device)
    torch.distributed.all_reduce(step_s, op=torch.distributed.ReduceOp.MAX)
    return max(1, math.ceil(r.seconds / float(step_s)))


def reference_steps(r, shard, state, labels, args, steps, rank, ranks):
    """The reference's first ``steps`` steps at the global batch, this
    rank's rows of it (the module docstring); the same on every rank."""
    device = torch.device(r.device)
    net = system.reference_network(r.config, device)
    load_into(net, state)
    n, b = len(labels), args.batch_size * ranks
    order = ref_inputs.epoch_order(n, r.seed)
    shard_data = ref_inputs.Shard(shard)
    batches = []
    for k in range(steps):
        idx = order[k * b:(k + 1) * b][rank::ranks]
        y, uv, pcm = ref_inputs.read_batch(shard_data, idx,
                                           args.train_crop_size, r.seed)
        video = ref_inputs.yuv420_to_rgb(torch.from_numpy(y).to(device),
                                         torch.from_numpy(uv).to(device))
        batches.append((video, torch.from_numpy(pcm).to(device).float(),
                        torch.from_numpy(labels[idx]).to(device).long()))
    gen = torch.Generator(device=device)
    gen.manual_seed(r.seed + 1)
    audio = {"samplerate": args.aud_sample_rate,
             "nfilt": 40 if args.aud_spec_type == 1 else 257}
    ref_model.Precision.checkpoint = device.type == "cuda"
    try:
        with global_batch(rank, ranks):
            return train_steps(net, batches, gen, args.base_lr, args.wd,
                               audio, rank, ranks)
    finally:
        ref_model.Precision.checkpoint = False


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks; its gradient is the sum of the
    ranks' gradients (each rank's loss depends on every rank's rows)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        torch.distributed.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad)
        return grad


@contextlib.contextmanager
def global_batch(rank, ranks):
    """The reference's train-mode BatchNorm over the global batch (two
    passes: the mean, then the biased variance about it) and its dropout
    masks drawn for the global batch, of which the rank keeps rows
    ``rank::ranks``."""
    saved = ref_model.batch_norm, ref_model._dropout

    def batch_norm(x, weight, bias, running_mean, running_var, train):
        if not train:
            return saved[0](x, weight, bias, running_mean, running_var,
                            train)
        dims = [0, *range(2, x.ndim)]
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        count = x.numel() // x.shape[1] * ranks
        mean = _SumOverRanks.apply(x.sum(dims)) / count
        centred = x - mean.view(shape)
        var = _SumOverRanks.apply(centred.square().sum(dims)) / count
        return (centred * torch.rsqrt(var + ref_model.BN_EPS).view(shape)
                * weight.view(shape) + bias.view(shape))

    def dropout(x, generator):
        shape = (x.shape[0], x.shape[1] * ranks, *x.shape[2:])
        keep = (torch.rand(shape, generator=generator, device=x.device)
                >= ref_model.DROPOUT)[:, rank::ranks]
        return torch.where(keep, x / (1.0 - ref_model.DROPOUT),
                           torch.zeros_like(x))

    ref_model.batch_norm, ref_model._dropout = batch_norm, dropout
    try:
        yield
    finally:
        ref_model.batch_norm, ref_model._dropout = saved


def train_steps(net, batches, generator, lr, wd, audio, rank, ranks,
                momentum=0.9):
    """``reference/train.py::train_steps`` on a rank's rows of the global
    batch: the flips drawn for the global batch, the rank's loss (the mean
    over its rows) differentiated, the gradients averaged over the ranks
    (the gradient of the global batch's mean loss), the coupled SGD update.
    Returns the global losses, the first momentum buffers and the last
    parameters."""
    net.train()
    names, params = zip(*net.named_parameters())
    bufs = [None] * len(params)
    losses, first = [], None
    with ref_train.exact_float32():
        for video, pcm, labels in batches:
            draws = ref_inputs.draw_augmentations(video.shape[0] * ranks,
                                                  generator)
            draws = {k: v[rank::ranks] for k, v in draws.items()}
            x = ref_inputs.augment(video, draws)
            spec = ref_inputs.logfbank(pcm, audio["samplerate"],
                                       audio["nfilt"])
            logits_v, logits_a = net(x, spec, generator)
            loss = (0.5 * ref_model.multihead_ce(logits_v, labels)
                    + 0.5 * ref_model.multihead_ce(logits_a, labels))
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                flat = torch.cat([g.reshape(-1) for g in grads]
                                 + [loss.detach().reshape(1)])
                torch.distributed.all_reduce(flat)
                flat /= ranks
                off = 0
                for i, p in enumerate(params):
                    g = flat[off:off + p.numel()].view_as(p)
                    off += p.numel()
                    d = g + wd * p
                    bufs[i] = d if bufs[i] is None else bufs[i].mul_(
                        momentum).add_(d)
                    p.sub_(lr * bufs[i])
            losses.append(float(flat[-1]))
            if first is None:
                first = {n: b.clone() for n, b in zip(names, bufs)}
            del grads, loss, logits_v, logits_a, flat
    return losses, first, {n: p.detach().clone()
                           for n, p in zip(names, params)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watch(procs):
    """End rank 0 at once when another rank fails, rather than leave it
    waiting at a collective that rank will not reach."""
    while True:
        for k, log, p in procs:
            code = p.poll()
            if code not in (None, 0):
                log.flush()
                text = Path(log.name).read_text()[-4000:]
                print(f"rank {k} exited {code}:\n{text}", file=sys.stderr,
                      flush=True)
                os._exit(1)
        if all(p.poll() == 0 for _, _, p in procs):
            return
        time.sleep(0.5)


def _join(procs):
    """Wait for the other ranks; ``{rank: exit code}`` of those that failed
    (a rank still running after ``JOIN_S`` is killed)."""
    codes = {}
    for k, log, p in procs:
        try:
            p.wait(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode != 0:
            codes[k] = p.returncode
    return codes


def _parent_watch(parent):
    """End this rank when rank 0's process has gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def main(argv=None):
    p = argparse.ArgumentParser(description="one rank of a dp4 run")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--work", required=True)
    a = p.parse_args(argv)
    threading.Thread(target=_parent_watch, args=(os.getppid(),),
                     daemon=True).start()
    work = Path(a.work)
    spec = json.loads((work / "run.json").read_text())
    r = harness.Run(cell=spec["cell"], seed=spec["seed"],
                    seconds=spec["seconds"], trace=False,
                    config=spec["config"], workload=spec["workload"],
                    device=spec["device"], cache=Path(spec["cache"]),
                    t0=time.perf_counter())
    steps = rank_run(r, a.rank, spec["ranks"], spec["port"])
    (work / f"rank{a.rank}.json").write_text(json.dumps({"steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
