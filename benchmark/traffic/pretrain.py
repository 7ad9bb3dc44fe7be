"""Pretraining traffic: ``Trainer.train_epoch`` over the cell's dataset,
batch after batch from the loader, until the window closes.

Set-up: the Trainer with the benchmark's weights and labels, the BN
warm-up batches, then the first steps (``warm_steps``), each through
``train_epoch`` on its own batch of the same epoch; what they produced is
kept for the check. The window then runs ``train_epoch`` on, from the next
batch of that epoch, and ends at the first step boundary after
``--seconds`` (the feed stops yielding); no SK step falls inside it. With
``--trace 1`` the profiler covers ``trace_steps`` steps from window step
``trace_from``.

After the window, with the system's state freed, the reference trains the
same first steps from the same weights on the same samples, crops, flips
and dropout masks, and the two are compared (``compare.training``).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import compare, flops, system
from benchmark.reference import inputs as ref_inputs
from benchmark.reference import train as ref_train
from benchmark.weights import load_into

TRAFFIC = "pretrain"  # what the readers of a run take it for (harness)


def run(r):
    w = r.workload
    split = {"imports": time.perf_counter() - r.t0}
    trainer, state, labels, shard = system.build(r)
    args = trainer.args
    split["build"] = time.perf_counter() - r.t0 - sum(split.values())
    trainer.sk_schedule = [math.inf]  # no SK step in the window
    trainer.warmup_batchnorm(r.config["bn_warmup_batches"])
    feed = system.Feed(trainer.loader)
    trainer.loader = feed
    names = [n for n, _ in trainer.model.named_parameters()]
    params = [p for _, p in trainer.model.named_parameters()]
    losses, first = [], None
    for _ in range(w["warm_steps"]):
        feed.budget = 1
        trainer.train_epoch(0)
        losses.append(trainer.history[-1]["loss"])
        if first is None:  # a leaf the step never moved has no buffer
            first = {n: trainer.optimizer.state[p].get(
                "momentum_buffer", torch.zeros_like(p)).clone()
                for n, p in zip(names, params)}
    last = {n: p.detach().clone() for n, p in zip(names, params)}
    system.synchronize(r.device)
    r.setup_s = time.perf_counter() - r.t0
    split["warm_up"] = r.setup_s - sum(split.values())
    r.extra["setup_split"] = split
    setup_peak = system.peak(r.device)

    system.reset_peak(r.device)
    tracer = system.Tracer(r.device) if r.trace else None
    start_at = feed.served + w["trace_from"]
    traced = {}

    def on_batch(k):
        if tracer is None:
            return
        if k == start_at and tracer.prof is None and tracer.wall_s is None:
            tracer.start()
            traced["from"] = k
        elif k == start_at + w["trace_steps"] and tracer.on:
            tracer.stop()
            traced["to"] = k

    feed.on_batch = on_batch
    feed.budget, feed.wait_s = None, 0.0
    first_window_batch = feed.served
    feed.deadline = time.perf_counter() + r.seconds
    t = time.perf_counter()
    trainer.train_epoch(0)
    system.synchronize(r.device)
    r.window_s = time.perf_counter() - t
    if tracer is not None and tracer.on:
        tracer.stop()
        traced["to"] = feed.served
    steps = feed.served - first_window_batch
    r.attempted, r.failed = steps, 0
    r.units = steps * args.batch_size
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
    del trainer, feed, params
    system.free()

    ref_losses, ref_first, ref_last = reference_steps(
        r, shard, state, labels, args, len(losses))
    readings, where = compare.training(losses, first, last, ref_losses,
                                       ref_first, ref_last, state, args.wd)
    r.extra.update(where, readings=readings, losses=losses,
                   ref_losses=ref_losses)
    r.checks = {k: (readings[k], lim) for k, lim in w["limits"].items()}


def reference_steps(r, shard, state, labels, args, steps, keep_rows=None,
                    fp8=False, bf16=False):
    """The reference's first ``steps`` steps of the run: the loader's
    first batches of epoch 0, the same crops, flips and dropout masks
    (the step generator is seeded ``seed + 1``)."""
    from benchmark.reference.model import Precision

    device = torch.device(r.device)
    net = reference_network_on(r, device)
    load_into(net, state)
    n, b = len(labels), args.batch_size
    order = ref_inputs.epoch_order(n, r.seed)
    data = ref_inputs.Shard(shard)
    batches = []
    for k in range(steps):
        idx = order[k * b:(k + 1) * b]
        y, uv, pcm = ref_inputs.read_batch(data, idx, args.train_crop_size,
                                           r.seed)
        video = ref_inputs.yuv420_to_rgb(torch.from_numpy(y).to(device),
                                         torch.from_numpy(uv).to(device))
        batches.append((video, torch.from_numpy(pcm).to(device).float(),
                        torch.from_numpy(labels[idx]).to(device).long()))
    gen = torch.Generator(device=device)
    gen.manual_seed(r.seed + 1)
    audio = {"samplerate": args.aud_sample_rate,
             "nfilt": 40 if args.aud_spec_type == 1 else 257}
    Precision.checkpoint = device.type == "cuda"
    Precision.fp8, Precision.bf16 = fp8, bf16
    try:
        return ref_train.train_steps(net, batches, gen, args.base_lr,
                                     args.wd, audio, keep_rows=keep_rows)
    finally:
        Precision.checkpoint = Precision.fp8 = Precision.bf16 = False


def reference_network_on(r, device):
    return system.reference_network(r.config, device)
