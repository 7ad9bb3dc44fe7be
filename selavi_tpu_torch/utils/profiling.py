"""Tracing and profiling hooks (``selavi_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around a training window, and the program's
spans and counters on that trace's clock.

``span(name)`` times its block on the host (``.seconds`` after exit).
Where a ``torch.profiler`` session is recording when it is entered (this
module's ``trace_window``, or any caller's profiler), it also opens
``record_function(name)``, so that the block lands in the trace as a
``user_annotation`` nested under its parent on the same thread, and, if
the session still records at its exit, adds its count and seconds to
``totals[name]``; ``count(name, n)`` adds to ``counters[name]`` where a
session records. With no profiler recording a span costs two clock reads
(``record_function`` alone costs microseconds even then). ``reset()``
clears ``totals`` and ``counters``.

``span(name, annotate=False)`` keeps its block out of the trace and in
``totals``: for a block that may hold a caller's profiler stop. An
annotation open at a stop is cut short, and the profiler ends it only
once the stop has flushed, after the device's last work, which stretches
the trace's window by an idle gap that no work made.

The spans sit at the port's layer boundaries: ``trainer.data`` and
``trainer.step`` (``train/loop.py``), ``loader.wait``, ``loader.collate``,
``loader.decode`` and the counter ``loader.batches`` (``data/loader.py``),
``train.input``, ``train.forward``, ``train.backward`` and
``train.optimizer`` (``train/step.py``), ``engine.aggregate``,
``engine.loader_start``, ``engine.data``, ``engine.match``,
``engine.solve``, ``engine.gather`` and ``engine.exchange``
(``selflabel/engine.py``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# True while a torch.profiler session records (a fraction of a microsecond)
_recording = torch._C._autograd._profiler_enabled

logger = logging.getLogger(__name__)

TRACE_NAME = "trace.json"

# name: [count, seconds] of the spans recorded, and name: count of the
# counters, since the last reset()
totals: dict = {}
counters: dict = {}


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


class span:
    """``with span(name) as s: ...``; ``s.seconds`` after the block. Records
    into the trace (unless ``annotate`` is false) and ``totals`` only where
    a profiler records at its entry and, for ``totals``, still at its exit
    (see the module docstring)."""

    __slots__ = ("name", "annotate", "seconds", "_t0", "_record",
                 "_annotation")

    def __init__(self, name: str, annotate: bool = True):
        self.name = name
        self.annotate = annotate
        self.seconds = None
        self._annotation = None

    def __enter__(self):
        self._record = _recording()
        if self._record and self.annotate:
            self._annotation = record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self._record and _recording():
            total = totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += self.seconds
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[name]`` where a profiler is recording."""
    if _recording():
        counters[name] = counters.get(name, 0) + n


def reset() -> None:
    totals.clear()
    counters.clear()
