"""Process-group helpers that the parallel modules share
(``selavi_tpu/parallel/mesh.py``).

JAX spans devices with one SPMD program over a ``('data', 'model')``
mesh; the port runs one process a GPU under ``torch.distributed``.
``make_grid`` lays the ranks out as that mesh (``Grid``: rank ``r = d * M
+ m`` of ``N``, with ``M = --model_axis``): the ``M`` ranks of data row
``d`` form its model group, the ``N / M`` ranks of model column ``m`` its
data group. The towers stay data-parallel over all ``N`` ranks; the head
stacks are split over the model axis (``HeadStack``'s owned slice), each
rank gathering its data row's features (``Grid.gather``) for its heads.

Where JAX fetches a row-sharded array to every host (``fetch_to_host``,
after ``pad_local_rows`` evened the shards), ``gather_rows`` assembles the
ranks' rows on every rank of a group and drops the rows a rank-strided
loader added as padding. ``broadcast_`` and ``broadcast_object`` hand one
rank's result to every rank. Without a process group each helper is the
identity on its input, so single-process code calls them unconditionally.
``data_parallel`` wraps a model in ``DistributedDataParallel``, and
``grid_parallel`` a model on a grid.
"""

from __future__ import annotations

import dataclasses
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


def data_parallel(module: torch.nn.Module, device: torch.device,
                  group=None) -> DistributedDataParallel:
    """``module`` (on ``device``) under DDP over ``group`` (the default
    group when None), which averages its gradients over the group's ranks
    and leaves its buffers alone in the forward: BatchNorm's statistics
    are the global batch's, so the buffers stay equal. torch 2.13 renamed
    that option ``forward_sync_buffers`` and warns on the old name, which
    earlier versions alone know."""
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in
            inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, **{sync: False})


@dataclasses.dataclass
class Grid:
    """This rank's place in the ``[N / M, M]`` process grid: rank ``rank =
    data_index * model_size + model_index`` of ``world``. ``model_group``
    holds the ``M`` ranks of this rank's data row (None at ``M = 1``, where
    it is this rank alone), ``data_group`` the ``N / M`` ranks of its model
    column: the ranks that hold the same heads (the default group at ``M =
    1``)."""

    rank: int
    world: int
    model_size: int
    data_index: int
    model_index: int
    model_group: Optional[Any]
    data_group: Any

    @property
    def data_size(self) -> int:
        return self.world // self.model_size

    def heads(self, headcount: int) -> tuple[int, int]:
        """(first, count) of the heads this rank owns."""
        count = headcount // self.model_size
        return self.model_index * count, count

    def owner(self, head: int, headcount: int) -> int:
        """The model index that owns ``head``."""
        return head // (headcount // self.model_size)

    def gathered_rows(self, rows: int, device=None) -> torch.Tensor:
        """The global-batch rows of the data row's gathered batch, in
        ``gather`` order: rank ``r`` holds rows ``r::N`` of the global batch
        (``rows`` of them), and the gather concatenates the ranks ``d * M``
        ... ``d * M + M - 1``."""
        first = self.data_index * self.model_size
        local = torch.arange(rows, device=device) * self.world
        return torch.cat([local + first + i for i in range(self.model_size)])

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data row's rows of ``x [n, ...]``, rank after rank, with a
        gradient (``_GatherModel``); ``x`` itself at ``M = 1``."""
        if self.model_group is None:
            return x
        return _GatherModel.apply(x, self.model_group, self.model_size)

    def gather_objects(self, obj) -> list:
        """Every model-group rank's ``obj`` (picklable host object), in
        model-index order; ``[obj]`` at ``M = 1``."""
        if self.model_group is None:
            return [obj]
        out = [None] * self.model_size
        tdist.all_gather_object(out, obj, group=self.model_group)
        return out

    def loss(self, value: torch.Tensor) -> torch.Tensor:
        """The global loss from each rank's loss over its heads (each a
        sum over the owned heads divided by the global headcount): the sum
        over the model group, averaged over the data rows (a host sync)."""
        buf = value.detach().to(comm_device(), torch.float64).reshape(1)
        tdist.all_reduce(buf)
        return buf[0] / self.data_size


def make_grid(model_axis: int = 1, headcount: int = 1) -> Optional[Grid]:
    """This rank's ``Grid`` for ``--model_axis`` over the default group;
    None without a process group (one process, ``M = 1``). Every rank
    calls it, in the same order as every other collective: it makes one
    group a data row and one a model column. Raises ``ValueError`` when
    ``M`` does not divide the headcount or the world size (JAX:
    ``state_shardings`` and ``make_mesh``)."""
    m = int(model_axis)
    if m < 1 or headcount % m:
        raise ValueError(f"--model_axis {m} must divide --headcount "
                         f"{headcount} (heads shard over the model axis)")
    rank, world_size, group = world()
    if world_size % m:
        raise ValueError(f"--model_axis {m} must divide the world size "
                         f"{world_size} (the ranks form a [world / "
                         f"model_axis, model_axis] grid)")
    if group is None:
        return None
    d, i = divmod(rank, m)
    if m == 1:
        return Grid(rank, world_size, 1, d, 0, None, group)
    rows = [tdist.new_group([r * m + j for j in range(m)])
            for r in range(world_size // m)]
    cols = [tdist.new_group(list(range(j, world_size, m))) for j in range(m)]
    return Grid(rank, world_size, m, d, i, rows[d], cols[i])


class _GatherModel(torch.autograd.Function):
    """All-gather over the model group with a gradient. Backward: the
    gathered rows' gradients summed over the group (each rank's heads add
    theirs), this rank's slice, times ``grad_scale``: with the group's
    ``M`` ranks the towers' DDP mean over all ``N`` ranks then averages
    over the ``N / M`` data rows, as their rows make up the global batch.
    Staged through ``comm_device()`` (the host under gloo)."""

    @staticmethod
    def forward(ctx, x, group, grad_scale: float):
        ctx.group, ctx.scale, ctx.rows = group, grad_scale, x.shape[0]
        ctx.index = tdist.get_rank(group)
        buf = x.detach().to(comm_device()).contiguous()
        parts = [torch.empty_like(buf)
                 for _ in range(tdist.get_world_size(group))]
        tdist.all_gather(parts, buf, group=group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        buf = grad.to(comm_device(), copy=True).contiguous()
        tdist.all_reduce(buf, group=ctx.group)
        rows = slice(ctx.index * ctx.rows, (ctx.index + 1) * ctx.rows)
        return buf[rows].to(grad.device) * ctx.scale, None, None


class _Part(torch.nn.Module):
    """A method of a model over some of its submodules, as a module of its
    own for a DDP of its own."""

    def __init__(self, fn, **modules):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class GridParallel(torch.nn.Module):
    """An ``AVModel`` on a grid with ``M > 1``: its towers under DDP over
    all ranks, its heads (this rank's slice) under DDP over the data
    group. One DDP over the whole model cannot be, since the ranks' head
    stacks differ."""

    def __init__(self, model, grid: Grid, device: torch.device):
        super().__init__()
        self.towers = data_parallel(_Part(
            model.towers, video_network=model.video_network,
            audio_network=model.audio_network), device)
        self.heads = data_parallel(_Part(
            model.heads, heads_v=model.heads_v, heads_a=model.heads_a),
            device, grid.data_group)

    def forward(self, video, audio, generator=None, shard=(0, 1)):
        return self.heads(*self.towers(video, audio, generator, shard),
                          generator=generator, shard=shard)


def grid_parallel(model, grid: Grid, device: torch.device):
    """``model`` for the train step on ``grid``: one DDP over all ranks at
    ``M = 1`` (the heads' data group is the world), ``GridParallel``
    otherwise."""
    if grid.model_size == 1:
        return data_parallel(model, device)
    return GridParallel(model, grid, device)


def gather_rows(local: torch.Tensor, valid: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
    """Every rank's rows of ``local [n, ...]`` where ``valid [n]`` holds,
    rank after rank of ``group`` (the default group when None), on every
    rank of it (on ``local``'s device). Each rank may hold a different
    ``n``. ``valid=None`` keeps every row."""
    if valid is None:
        valid = torch.ones(local.shape[0], dtype=torch.bool,
                           device=local.device)
    if not tdist.is_initialized():
        return local[valid.to(local.device, torch.bool)]
    dev = comm_device()
    world_size = tdist.get_world_size(group)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(world_size)]
    tdist.all_gather(counts, torch.tensor([local.shape[0]], device=dev),
                     group=group)
    most = int(max(c.item() for c in counts))
    pad = most - local.shape[0]
    rows = torch.cat([local.to(dev),
                      local.new_zeros((pad, *local.shape[1:]), device=dev)])
    # uint8: the mask crosses NCCL as bytes
    keep = torch.cat([valid.to(dev, torch.uint8),
                      torch.zeros(pad, dtype=torch.uint8, device=dev)])
    parts = [torch.empty_like(rows) for _ in range(world_size)]
    keeps = [torch.empty_like(keep) for _ in range(world_size)]
    tdist.all_gather(parts, rows, group=group)
    tdist.all_gather(keeps, keep, group=group)
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
