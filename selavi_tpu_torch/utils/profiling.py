"""Tracing and profiling hooks (``selavi_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around a training window, named annotations
that line the device timeline up with the loop, and a scoped host timer.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

logger = logging.getLogger(__name__)

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace_window(dump_path: str, enabled: bool = True,
                 record_shapes: bool = False):
    """Trace the enclosed block (host ops, and the card's kernels and
    copies when there is a card) into the Chrome trace
    ``{dump_path}/profile/trace.json``; yields the ``torch.profiler``
    profile (None when off). ``record_shapes`` adds each host op's input
    shapes, which name the layer behind a kernel. A profiler that fails to
    start or stop is logged and the block runs on, as in the JAX
    package."""
    if not enabled:
        yield None
        return
    trace_dir = os.path.join(dump_path, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=record_shapes)
    try:
        prof.start()
        started = True
    except RuntimeError as e:
        logger.warning("profiler trace unavailable: %s", e)
        started = False
    try:
        yield prof if started else None
    finally:
        if started:
            path = os.path.join(trace_dir, TRACE_NAME)
            try:
                prof.stop()
                prof.export_chrome_trace(path)
                logger.info("profiler trace written to %s", path)
            except RuntimeError as e:
                logger.warning("profiler stop failed: %s", e)


def step_annotation(name: str):
    """Named range that shows up on the trace's timeline."""
    return record_function(name)


class Stopwatch:
    """Cheap scoped host timer for phase-level logging."""

    def __init__(self, label: str, log=logger.info):
        self.label = label
        self.log = log

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.log("%s took %.3fs", self.label, time.perf_counter() - self.t0)
