"""Projection heads as one stacked parameter set (``selavi_tpu/models/heads.py``).

``HeadStack`` holds ``headcount`` independent heads as ``[H, ...]``
parameters and applies them with batched matmuls: features ``[B, D]`` ->
logits ``[H, B, K]``. Per head (``use_mlp=True``):

    Dropout(0.3) -> Dense(512, no bias) -> BN -> ReLU -> Dropout(0.3) -> Dense(K)

and ``use_mlp=False`` is the plain ``Dense(K)``. Dense kernels keep the
JAX package's ``[H, in, out]`` layout. Dropout masks are drawn per head
from the explicit generator passed to ``forward``.

Split over a grid's model axis (``parallel/mesh.py``), a stack holds the
``count`` heads from ``first`` on (``owned``): their parameters, BN
statistics and, in the optimizer, their momentum. It draws the weights of
all ``headcount`` heads and keeps its slice, and its dropout masks are
those of all heads over the global batch, of which it keeps its heads and
the rows it was given (``head_dropout``), so that every number equals the
unsplit stack's. Its BN statistics are reduced over ``bn_group``, the
ranks that hold the same heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from selavi_tpu_torch.models.common import flax_batch_norm, uniform_fan_in_

DROPOUT_RATE = 0.3


def dropout(x, rate: float, generator: Optional[torch.Generator],
            shard: tuple[int, int] = (0, 1)):
    """Inverted dropout with an explicit generator (keep prob 1 - rate).
    With ``shard = (rank, world)`` the mask is drawn for ``world`` times
    the batch along dim 0 and this rank keeps rows ``rank::world``."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit generator")
    rank, world = shard
    shape = list(x.shape)
    shape[0] *= world
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if world > 1:
        keep = keep.unflatten(0, (-1, world)).select(1, rank)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def head_dropout(x, rate: float, generator: Optional[torch.Generator],
                 heads: tuple[int, int], rows: tuple[torch.Tensor, int]):
    """Inverted dropout of ``x [h, b, ...]``, heads ``first`` ...
    ``first + h - 1`` of ``heads = (first, headcount)`` at rows ``index``
    of a global batch of ``total`` (``rows = (index [b], total)``): the
    mask is drawn for all heads and the global batch, as by one process
    with the whole stack and batch, and the slice kept."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit generator")
    first, headcount = heads
    index, total = rows
    keep = torch.rand((headcount, total, *x.shape[2:]), generator=generator,
                      device=x.device) >= rate
    keep = keep[first:first + x.shape[0]][:, index.to(x.device)]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def shard_rows(rows: int, shard: tuple[int, int] = (0, 1),
               device=None) -> tuple[torch.Tensor, int]:
    """``(index, total)`` of ``rows`` local rows that are rows
    ``rank::world`` of the global batch (``shard = (rank, world)``)."""
    rank, world = shard
    return torch.arange(rows, device=device) * world + rank, rows * world


class HeadStack(nn.Module):
    def __init__(self, headcount: int, in_dim: int, num_classes: int,
                 n_hidden: int = 512, use_mlp: bool = True,
                 dropout_rate: float = DROPOUT_RATE,
                 generator: Optional[torch.Generator] = None,
                 owned: Optional[tuple[int, int]] = None, bn_group=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.headcount = headcount
        self.first, count = owned if owned is not None else (0, headcount)
        self.use_mlp = use_mlp
        self.dropout_rate = dropout_rate
        self.bn_group = bn_group
        own = slice(self.first, self.first + count)

        def owned_(t, fan_in):
            # all heads' draws, in order: the generator goes on as unsplit
            return nn.Parameter(uniform_fan_in_(t, fan_in, g)[own].clone())

        proj_in = n_hidden if use_mlp else in_dim
        if use_mlp:
            self.hidden_weight = owned_(
                torch.empty(headcount, in_dim, n_hidden), in_dim)
            self.bn_weight = nn.Parameter(torch.ones(count, n_hidden))
            self.bn_bias = nn.Parameter(torch.zeros(count, n_hidden))
            self.register_buffer("bn_running_mean",
                                 torch.zeros(count, n_hidden))
            self.register_buffer("bn_running_var",
                                 torch.ones(count, n_hidden))
        self.proj_weight = owned_(
            torch.empty(headcount, proj_in, num_classes), proj_in)
        self.proj_bias = owned_(torch.empty(headcount, num_classes), proj_in)

    @property
    def local_heads(self) -> int:
        return self.proj_weight.shape[0]

    def forward(self, feats, generator: Optional[torch.Generator] = None,
                rows: Optional[tuple[torch.Tensor, int]] = None):
        """feats [B, D] -> logits [h, B, K] of the owned heads; ``rows``
        places the B rows in the global batch for the dropout masks
        (``head_dropout``; by default the whole batch)."""
        h = self.local_heads
        feats = feats.to(self.proj_weight.dtype)
        if not self.use_mlp:
            return torch.baddbmm(self.proj_bias[:, None, :],
                                 feats.expand(h, *feats.shape),
                                 self.proj_weight)
        train = self.training
        b = feats.shape[0]
        if rows is None:
            rows = shard_rows(b)
        heads = (self.first, self.headcount)
        x = feats.expand(h, *feats.shape)
        if train:
            x = head_dropout(x, self.dropout_rate, generator, heads, rows)
        x = torch.bmm(x, self.hidden_weight)  # [h, B, hidden]
        # BN per (head, channel) over the batch: [h, B, C] -> [B, h*C]
        x = x.transpose(0, 1).reshape(b, -1)
        x = flax_batch_norm(x, self.bn_weight.reshape(-1),
                            self.bn_bias.reshape(-1),
                            self.bn_running_mean.view(-1),
                            self.bn_running_var.view(-1), train,
                            group=self.bn_group)
        x = torch.relu(x).reshape(b, h, -1).transpose(0, 1)
        if train:
            x = head_dropout(x, self.dropout_rate, generator, heads, rows)
        return torch.baddbmm(self.proj_bias[:, None, :], x, self.proj_weight)

    @torch.no_grad()
    def permute_output(self, head: int, perm) -> None:
        """Reorder head ``head``'s output clusters (a global head index; a
        no-op where this stack does not own it): new column k is old
        column ``perm[k]`` of the final Dense kernel and bias."""
        i = head - self.first
        if not 0 <= i < self.local_heads:
            return
        perm = torch.as_tensor(perm, dtype=torch.long,
                               device=self.proj_weight.device)
        self.proj_weight[i] = self.proj_weight[i][:, perm]
        self.proj_bias[i] = self.proj_bias[i][perm]
