"""Reading a ``torch.profiler`` Chrome trace of the card: device busy and
idle time, device time by operation, and the longest idle gaps with the
host operation under each (the innermost host event, an op or a CUDA
runtime call, that spans the gap's middle, or the last one before it).

The busy time is the union of the device's intervals (kernels, copies and
fills), so overlapping work on two streams counts once; the window is the
span of every timed event in the trace; idle is the window less the busy
time.
"""

from __future__ import annotations

import json
import math

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME = 200  # characters of a name kept in the breakdown
PROFILER_ROOT = "PyTorch Profiler"  # the event that spans the whole trace


def union(spans):
    """The merged intervals of ``spans`` [(start, end)], in order."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_op_at(host, t):
    """The innermost host event that spans time ``t`` (µs), or, where none
    does (the host ran Python between ops), ``after`` the last one that
    began before it."""
    best, before = None, None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
        if a <= t and (before is None or a > before[0]):
            before = (a, name)
    if best:
        return best[1]
    return f"after {before[1]}" if before else "(no host event)"


def summarize(events):
    """``events``: the ``traceEvents`` of a Chrome trace. Returns seconds:
    ``busy_s``, ``window_s``, ``device_by_name`` {name: [count, s]},
    ``device_ops`` and ``idle_gaps`` (each at most ten ``[name, s]``)."""
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not device or not timed:
        return None
    by_name = {}
    for e in device:
        c = by_name.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += e["dur"] / 1e6
    start = min(e["ts"] for e in timed)
    end = max(e["ts"] + e["dur"] for e in timed)
    busy = union((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(b - a for a, b in busy)
    gaps, last = [], start
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if end > last:
        gaps.append((last, end))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in timed
            if e.get("cat") not in DEVICE_CATS
            and not e["name"].startswith(PROFILER_ROOT)]
    idle = [[_host_op_at(host, (a + b) / 2)[:NAME], (b - a) / 1e6]
            for a, b in gaps[:TOP]]
    ops = sorted(([n[:NAME], c[1]] for n, c in by_name.items()),
                 key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (end - start) / 1e6,
            "device_by_name": by_name, "device_ops": ops, "idle_gaps": idle}


def load(path):
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


def mean_duration(summary, fragment):
    """Mean seconds of the device ops whose name holds ``fragment``, or
    None."""
    count, total = 0, 0.0
    for name, (n, s) in summary["device_by_name"].items():
        if fragment in name:
            count += n
            total += s
    return total / count if count else None


def finite(x):
    return x is not None and math.isfinite(x)
