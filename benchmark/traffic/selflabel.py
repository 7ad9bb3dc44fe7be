"""Self-labeling traffic: whole SK steps, ``Trainer.maybe_cluster`` again
and again, each an aggregation over the cell's N samples through a fresh
eval loader, the head logits, the Gaussian marginals and one
Sinkhorn-Knopp solve a head.

With ``ind_groups`` G the heads fall into G groups, each solved on the
features of its own aggregation pass: an SK step reads the dataset G
times, each pass through a fresh eval loader.

Set-up: the Trainer with the benchmark's weights and labels runs the
first SK step (the one that matches the modalities and permutes the audio
heads); then the benchmark's weights are loaded again, its own cluster
sizes (drawn from the seed) replace the marginal state and its own host
generator the Trainer's, so that every window step starts from the
benchmark's inputs alone. The window runs SK steps until ``--seconds``
have passed (with ``--trace 1`` at least ``trace_from + 1``, the profiler
over step ``trace_from``).

After the window the reference works out the window's first SK step from
the same weights, samples, crops, flips, sizes and head groups, and
judges the labels the system chose against its own scores
(``reference/train.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import flops, system
from benchmark.reference import inputs as ref_inputs
from benchmark.reference import train as ref_train
from benchmark.reference.model import Precision
from benchmark.traffic.pretrain import reference_network_on
from benchmark.weights import load_into

TRAFFIC = "selflabel"  # what the readers of a run take it for (harness)


def cluster_sizes(seed, headcount, k, n, sd):
    """Gaussian cluster sizes ``(N(0, 1) * sd + 1) * n / k`` a head."""
    rng = np.random.default_rng((seed, 2))
    return (rng.standard_normal((headcount, k)) * sd + 1.0) * (n / k)


def host_rng(seed):
    """The host generator that the window's SK steps draw from."""
    return np.random.default_rng((seed, 3))


def head_groups(seed, headcount, groups):
    """The heads of each group in the window's first SK step: the heads
    shuffled by the host generator, group ``g`` every ``groups``-th of
    them from the ``g``-th."""
    order = list(range(headcount))
    host_rng(seed).shuffle(order)
    return [order[g::groups] for g in range(groups)]


def run(r):
    from selavi_tpu_torch.selflabel import engine
    from selavi_tpu_torch.selflabel.marginals import MarginalState

    w = r.workload
    split = {"imports": time.perf_counter() - r.t0}
    trainer, state, labels, shard = system.build(r)
    args = trainer.args
    n = len(trainer.dataset)
    split["build"] = time.perf_counter() - r.t0 - sum(split.values())
    trainer.sk_schedule.append(0)
    trainer.maybe_cluster(0)  # the first SK step, with matching
    load_into(trainer.model, state)
    sizes = cluster_sizes(r.seed, args.headcount, args.mlp_dim, n,
                          args.gauss_sd)
    trainer.sl_state.marginals = MarginalState(dists=sizes.copy())
    trainer.np_rng = host_rng(r.seed)
    system.synchronize(r.device)
    r.setup_s = time.perf_counter() - r.t0
    split["first_sk_step"] = r.setup_s - sum(split.values())
    r.extra["setup_split"] = split
    setup_peak = system.peak(r.device)

    system.reset_peak(r.device)
    tracer = system.Tracer(r.device) if r.trace else None
    steps, judged = 0, None
    t = time.perf_counter()
    while True:
        if tracer is not None and steps == w["trace_from"]:
            tracer.start()
        trainer.sk_schedule.append(0)
        trainer.maybe_cluster(0)
        if tracer is not None and tracer.on:
            tracer.stop()
        r.timings.append(dict(engine.timings))
        if judged is None:
            judged = (trainer.sl_state.selflabels.copy(),
                      trainer.history[-1]["sk_cost"],
                      trainer._eval_iter_count)
        steps += 1
        done = time.perf_counter() - t >= r.seconds
        if done and (tracer is None or steps > w["trace_from"]):
            break
    system.synchronize(r.device)
    r.window_s = time.perf_counter() - t
    r.attempted, r.failed, r.units = steps, 0, steps
    r.window_peak_bytes = system.peak(r.device)
    r.memory_peak_bytes = max(setup_peak, r.window_peak_bytes)
    r.flops = flops.clip_flops(args.__dict__, flops.spec_frames(
        args.num_sec_aud, args.aud_sample_rate))
    r.extra["n"], r.extra["k"] = n, args.mlp_dim
    r.extra["passes"] = args.ind_groups  # aggregation passes a step
    if tracer is not None:
        r.summary, r.traced_wall_s = tracer.summary, tracer.wall_s
        r.traced_steps, r.traced_units = 1, n
    trainer.loader.close()
    del trainer
    system.free()

    sys_labels, sys_cost, count = judged
    gap, cost_gap = judge(r, shard, state, sys_labels, sys_cost, args,
                          sizes, count)
    r.checks = {"label_gap": (gap, w["limits"]["label_gap"]),
                "cost_gap": (cost_gap, w["limits"]["cost_gap"])}


def reference_step(r, shard, state, args, sizes, count, fp8=False):
    """The reference's SK step whose last aggregation pass is the run's
    pass number ``count`` (pass ``p``'s eval loader is seeded ``seed +
    7919 + p``; the flips continue the generator seeded ``seed + 2``
    after the batches of the passes before): per head its labels, score
    and cost, each head on the features of its group's pass."""
    device = torch.device(r.device)
    net = reference_network_on(r, device)
    load_into(net, state)
    n = r.config[r.workload["samples"]]
    b = min(args.sk_agg_batch, n)
    groups = head_groups(r.seed, args.headcount, args.ind_groups)
    first = count - len(groups) + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(r.seed + 2)
    for _ in range(first - 1):  # the earlier passes' flips
        for s in range(0, n, b):
            ref_inputs.draw_augmentations(min(b, n - s), gen)
    data = ref_inputs.Shard(shard)

    def batches(seed):
        for s in range(0, n, b):
            idx = np.arange(s, min(s + b, n))
            y, uv, pcm = ref_inputs.read_batch(data, idx,
                                               args.train_crop_size, seed)
            video = ref_inputs.yuv420_to_rgb(torch.from_numpy(y).to(device),
                                             torch.from_numpy(uv).to(device))
            yield video, torch.from_numpy(pcm).to(device).float()

    audio = {"samplerate": args.aud_sample_rate,
             "nfilt": 40 if args.aud_spec_type == 1 else 257}
    out = [None] * args.headcount
    for g, heads in enumerate(groups):
        Precision.fp8 = fp8
        try:
            feat_v, feat_a = ref_train.features(
                net, batches(r.seed + 7919 + first + g), gen, audio)
            log_p = ref_train.log_probs(net, feat_v, feat_a)
        finally:
            Precision.fp8 = False
        del feat_v, feat_a
        for h in heads:
            log_r = ref_train.sorted_marginal(sizes[h], log_p[h])
            out[h] = ref_train.sinkhorn(log_p[h], log_r,
                                        lamb=float(args.lamb))
        del log_p
    return out


def judge(r, shard, state, sys_labels, sys_cost, args, sizes, count):
    """``(label_gap, cost_gap)`` of the system's SK step whose last pass
    is ``count``."""
    heads = reference_step(r, shard, state, args, sizes, count)
    gap = max(ref_train.label_gap(score, sys_labels[:, h])
              for h, (_, score, _) in enumerate(heads))
    ref_cost = float(np.mean([cost for _, _, cost in heads]))
    return gap, abs(sys_cost - ref_cost) / abs(ref_cost)
