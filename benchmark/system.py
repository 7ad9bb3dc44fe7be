"""The system under test as the benchmark drives it: ``selavi_tpu_torch``'s
``Trainer`` built from the port's own parser on the configuration's
flags, over the benchmark's shard, with the benchmark's weights and
labels; the feed that ends a window; the profiler around part of it.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np
import torch

from benchmark import data, trace, weights
from benchmark.reference.model import Network


def command_line(run, parser):
    """The port's command line of a run: every key of the configuration
    that the port's parser takes, then the cell's ``flags``."""
    known = set(vars(parser.parse_args([])))
    merged = {k: v for k, v in run.config.items()
              if k in known and not isinstance(v, (dict, list))}
    merged.update(run.workload.get("flags", {}))
    return [f"--{k}={v}" for k, v in merged.items()]


def inputs(run):
    """``(state, labels, shard)``, what a run hands both the system and
    the reference: the weights (``weights.make_state``) and the self-labels
    ``[N, H]`` drawn from the seed, and the shard's path."""
    c = run.config
    shard = data.shard_path(c, run.cache)
    state = weights.make_state(reference_network(c), run.seed, run.device)
    labels = np.random.default_rng((run.seed, 1)).integers(
        0, c["mlp_dim"], (c[run.workload["samples"]], c["headcount"]),
        dtype=np.int32)
    return state, labels, shard


def build(run):
    """``(trainer, state, labels, shard)``: the Trainer over a dataset of
    the cell's length, with the run's ``inputs`` in place of its weights
    and self-labels."""
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.data.factory import build_dataset
    from selavi_tpu_torch.train.loop import Trainer

    state, labels, shard = inputs(run)
    parser = parse_arguments()
    dump = os.path.join(tempfile.gettempdir(), "portbench_dump")
    argv = command_line(run, parser) + [
        "--ds_name=packed", f"--root_dir={shard}", f"--seed={run.seed}",
        f"--dump_path={dump}"]
    args = parser.parse_args(argv)
    dataset = data.ModN(build_dataset(args), len(labels))
    trainer = Trainer(args, dataset, device=run.device)
    weights.load_into(trainer.model, state)
    trainer.sl_state.selflabels = labels.copy()
    return trainer, state, labels, shard


def reference_network(config, device=None):
    with torch.device(device or "cpu"):
        return Network(config["vid_base_arch"], config["aud_base_arch"],
                       config["headcount"], config["mlp_dim"])


class Feed:
    """The Trainer's loader, one iterator across calls: each call yields
    ``budget`` batches, or with no budget until ``deadline`` (the host
    clock) has passed, at a step boundary. Keeps the seconds spent in the
    loader's ``next()`` and calls ``on_batch(k)`` before batch ``k``."""

    def __init__(self, loader):
        self.loader = loader
        self.batch_size = loader.batch_size
        self._it = None
        self.budget = None
        self.deadline = None
        self.served = 0
        self.wait_s = 0.0
        self.on_batch = None

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        if self._it is None:
            self.loader.set_epoch(epoch)

    def __iter__(self):
        if self._it is None:
            self._it = iter(self.loader)
        while True:
            if self.budget is not None:
                if self.budget <= 0:
                    return
                self.budget -= 1
            elif time.perf_counter() >= self.deadline:
                return
            if self.on_batch is not None:
                self.on_batch(self.served)
            t = time.perf_counter()
            try:
                batch = next(self._it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t
            self.served += 1
            yield batch

    def close(self):
        if self._it is not None:
            self._it.close()
            self._it = None
        self.loader.close()


class Tracer:
    """``torch.profiler`` over the card and the host from ``start()`` to
    ``stop()``, each after a synchronisation; ``stop`` reads the trace
    (``trace.summarize``) and deletes it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.summary = None
        self.wall_s = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t = time.perf_counter()

    @property
    def on(self):
        return self.prof is not None and self.wall_s is None

    def stop(self):
        self._sync()
        self.wall_s = time.perf_counter() - self.t
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.summary = trace.load(path)
        finally:
            os.remove(path)
        self.prof = None


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device):
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free():
    """Return the device memory of the state the caller dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
