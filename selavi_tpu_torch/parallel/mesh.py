"""Process-group helpers that the data-parallel modules share
(``selavi_tpu/parallel/mesh.py``).

JAX spans devices with one SPMD program over a ``data`` mesh; the port
runs one process a GPU under ``torch.distributed``. Where JAX fetches a
row-sharded array to every host (``fetch_to_host``, after
``pad_local_rows`` evened the shards), ``gather_rows`` assembles the
ranks' rows on every rank and drops the rows a rank-strided loader added
as padding. ``broadcast_`` and ``broadcast_object`` hand rank 0's result to
every rank. Without a process group each helper is the identity on its
input, so single-process code calls them unconditionally.
``data_parallel`` wraps a model in ``DistributedDataParallel``.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional

import torch
import torch.distributed as tdist
from torch.nn.parallel import DistributedDataParallel


def world() -> tuple[int, int, Optional[Any]]:
    """(rank, world_size, group): the default group when one is
    initialized (world 1 included), else (0, 1, None)."""
    if not tdist.is_initialized():
        return 0, 1, None
    return tdist.get_rank(), tdist.get_world_size(), tdist.group.WORLD


def comm_device() -> torch.device:
    """Where the group's tensors live: the current card under NCCL, the
    host under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_parallel(module: torch.nn.Module,
                  device: torch.device) -> DistributedDataParallel:
    """``module`` (on ``device``) under DDP, which averages its gradients
    over the ranks and leaves its buffers alone in the forward: BatchNorm's
    statistics are the global batch's, so the buffers stay equal. torch
    2.13 renamed that option ``forward_sync_buffers`` and warns on the old
    name, which earlier versions alone know."""
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in
            inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        **{sync: False})


def gather_rows(local: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's rows of ``local [n, ...]`` where ``valid [n]`` holds,
    rank after rank, on every rank (on ``local``'s device). Each rank may
    hold a different ``n``. ``valid=None`` keeps every row."""
    if valid is None:
        valid = torch.ones(local.shape[0], dtype=torch.bool,
                           device=local.device)
    if not tdist.is_initialized():
        return local[valid.to(local.device, torch.bool)]
    dev = comm_device()
    world_size = tdist.get_world_size()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(world_size)]
    tdist.all_gather(counts, torch.tensor([local.shape[0]], device=dev))
    most = int(max(c.item() for c in counts))
    pad = most - local.shape[0]
    rows = torch.cat([local.to(dev),
                      local.new_zeros((pad, *local.shape[1:]), device=dev)])
    # uint8: the mask crosses NCCL as bytes
    keep = torch.cat([valid.to(dev, torch.uint8),
                      torch.zeros(pad, dtype=torch.uint8, device=dev)])
    parts = [torch.empty_like(rows) for _ in range(world_size)]
    keeps = [torch.empty_like(keep) for _ in range(world_size)]
    tdist.all_gather(parts, rows)
    tdist.all_gather(keeps, keep)
    return torch.cat(parts)[torch.cat(keeps).bool()].to(local.device)


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``tensor`` in place with rank ``src``'s; returns it."""
    if tdist.is_initialized():
        buf = tensor.to(comm_device())
        tdist.broadcast(buf, src)
        if buf is not tensor:
            tensor.copy_(buf)
    return tensor


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (any picklable host object) on every rank."""
    if not tdist.is_initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src)
    return box[0]


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The mean of a 0-dim tensor over the ranks (a host sync)."""
    if not tdist.is_initialized():
        return value
    buf = value.detach().to(comm_device(), torch.float64).reshape(1)
    tdist.all_reduce(buf)
    return buf[0] / tdist.get_world_size()
