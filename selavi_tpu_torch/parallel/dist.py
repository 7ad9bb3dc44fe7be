"""Process groups and preemption handling (``selavi_tpu/parallel/dist.py``).

* ``init_distributed_mode``: under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) it joins the
  process group, one process a GPU: NCCL on the card the process's
  ``LOCAL_RANK`` names, gloo when the caller asked for the CPU (the
  tests). A group the caller already initialized is taken as it is.
  Without either it stays rank 0 of 1 with no group. ``distributed`` does
  the same for a CLI and destroys the group it created at exit;
  ``sync_hosts`` is a barrier over the group.
* signal handling: SIGUSR1 sets a flag that the train loop polls after
  every step; the loop then writes a checkpoint stamped with the current
  epoch and exits 0, and the scheduler's restart resumes from it. A bare
  SIGTERM is logged and ignored. Under a group the ranks agree on the flag
  (``StopVote``) before any of them takes that exit.
* the host-RSS watchdog: above its limit ``memory_pressure`` sets the same
  flag, so the loop takes the same exit instead of an OOM kill.
"""

from __future__ import annotations

import contextlib
import logging
import os
import resource
import signal

import torch
import torch.distributed as tdist

from selavi_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")

_SIGNAL_FLAG = {"received": False}


def init_distributed_mode(args=None, device: DeviceLike = None
                          ) -> tuple[int, int]:
    """Join the process group that torchrun's variables describe; returns
    (rank, world_size), also recorded on ``args`` as ``rank`` /
    ``world_size``.

    The backend follows ``device``: NCCL for the card (the default),
    after ``torch.cuda.set_device(LOCAL_RANK)``, and gloo for ``"cpu"``.
    CUDA without NCCL raises, as does a ``WORLD_SIZE`` above 1 without
    the other variables."""
    env = os.environ
    if not tdist.is_initialized():
        missing = [k for k in TORCHRUN_VARS if k not in env]
        if not missing:
            if resolve_device(device).type == "cuda":
                if not tdist.is_nccl_available():
                    raise RuntimeError(
                        "this torch build has no NCCL, which a process "
                        "group on the card needs")
                local = torch.device("cuda", int(env["LOCAL_RANK"]))
                torch.cuda.set_device(local)
                tdist.init_process_group("nccl", device_id=local)
            else:
                tdist.init_process_group("gloo")
        elif int(env.get("WORLD_SIZE", "1")) > 1:
            raise ValueError(
                f"WORLD_SIZE={env['WORLD_SIZE']} without {missing}: launch "
                f"the ranks with torchrun")
    rank, world_size = ((tdist.get_rank(), tdist.get_world_size())
                        if tdist.is_initialized() else (0, 1))
    if tdist.is_initialized():
        logger.info("process group: backend %s, rank %d of %d",
                    tdist.get_backend(), rank, world_size)
    if args is not None:
        args.rank = rank
        args.world_size = world_size
    return rank, world_size


@contextlib.contextmanager
def distributed(args=None, device: DeviceLike = None):
    """``init_distributed_mode`` for a CLI's lifetime; yields (rank,
    world_size) and destroys the group at exit when it created it."""
    created = not tdist.is_initialized()
    ranks = init_distributed_mode(args, device)
    try:
        yield ranks
    finally:
        if created and tdist.is_initialized():
            tdist.destroy_process_group()


def sync_hosts() -> None:
    """Barrier over the process group (none without a group)."""
    if tdist.is_initialized():
        tdist.barrier()


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


class StopVote:
    """The preemption exit, agreed across ranks.

    A rank that took the exit alone would leave the others waiting at
    their next collective. So every step each rank contributes its flag
    (SIGUSR1 or memory pressure) to an asynchronous MAX all-reduce over a
    gloo group, on the host: no device tensor and no host sync of the step
    are involved. ``poll`` returns the previous step's result, which every
    rank reads at the same step, so all ranks stop together, one step after
    the first of them saw its flag. Without a group it is the local flag."""

    def __init__(self):
        self.group = None
        self.pending = None
        if tdist.is_initialized():
            # the default group when it is gloo, else a gloo group beside it
            self.group = (None if tdist.get_backend() == "gloo"
                          else tdist.new_group(backend="gloo"))

    def poll(self) -> bool:
        local = signal_received() or memory_pressure()
        if not tdist.is_initialized():
            return local
        if self.drain():
            return True  # every rank stops here, with no vote in flight
        flag = torch.tensor([int(local)], dtype=torch.int32)
        work = tdist.all_reduce(flag, op=tdist.ReduceOp.MAX,
                                group=self.group, async_op=True)
        self.pending = (work, flag)
        return False

    def drain(self) -> bool:
        """Wait for the vote in flight, if any; True when a rank voted to
        stop."""
        if self.pending is None:
            return False
        work, flag = self.pending
        self.pending = None
        work.wait()
        return bool(flag.item())


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
