"""Process setup and preemption handling (``selavi_tpu/parallel/dist.py``).

* ``init_distributed_mode``: the port trains in one process on one card;
  it records rank 0 and world size 1, and refuses an environment that
  asks for more processes (multi-GPU is ROADMAP Queue 1 item 11).
* signal handling: SIGUSR1 sets a flag that the train loop polls after
  every step; the loop then writes a checkpoint stamped with the current
  epoch and exits 0, and the scheduler's restart resumes from it. A bare
  SIGTERM is logged and ignored.
* the host-RSS watchdog: above its limit ``memory_pressure`` sets the same
  flag, so the loop takes the same exit instead of an OOM kill.
"""

from __future__ import annotations

import logging
import os
import resource
import signal

logger = logging.getLogger(__name__)

MULTI_GPU_ITEM = "11 (multi-GPU)"

_SIGNAL_FLAG = {"received": False}


def init_distributed_mode(args=None) -> tuple[int, int]:
    """Returns (rank, world_size) = (0, 1), also recorded on ``args`` as
    ``rank`` / ``world_size``. Raises NotImplementedError when the
    environment asks for more than one process."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world_size}: the port trains in one process on one "
            f"card; multi-GPU is ROADMAP Queue 1 item {MULTI_GPU_ITEM}")
    if args is not None:
        args.rank = 0
        args.world_size = 1
    return 0, 1


def _handler(signum, frame):
    logger.warning("signal %d received; will checkpoint and exit", signum)
    _SIGNAL_FLAG["received"] = True


def init_signal_handler():
    """Install the SIGUSR1 preemption-warning handler and ignore a bare
    SIGTERM. Call from the main thread."""
    _SIGNAL_FLAG["received"] = False
    signal.signal(signal.SIGUSR1, _handler)
    signal.signal(signal.SIGTERM, lambda s, f: logger.info("sigterm ignored"))


def signal_received() -> bool:
    return _SIGNAL_FLAG["received"]


_MEM_WATCHDOG = {"limit_bytes": 0, "page": 0}


def init_memory_watchdog(limit_gb: float):
    """Arm the host-RSS watchdog at ``limit_gb`` (0 disarms it)."""
    _MEM_WATCHDOG["limit_bytes"] = int(limit_gb * 1e9)
    _MEM_WATCHDOG["page"] = resource.getpagesize()
    if limit_gb > 0:
        logger.info("host-RSS watchdog armed at %.1f GB", limit_gb)


def host_rss_bytes() -> int:
    """Current RSS from /proc/self/statm (~µs); 0 where there is none."""
    page = _MEM_WATCHDOG["page"] or 4096
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    except OSError:  # non-Linux: watchdog inert
        return 0


def memory_pressure() -> bool:
    limit = _MEM_WATCHDOG["limit_bytes"]
    if not limit:
        return False
    rss = host_rss_bytes()
    if rss >= limit:
        logger.warning(
            "host RSS %.1f GB >= limit %.1f GB; will checkpoint and exit "
            "for requeue",
            rss / 1e9,
            limit / 1e9,
        )
        _SIGNAL_FLAG["received"] = True  # reuse the preemption exit path
        return True
    return False
