"""Optimizer and LR schedule (``selavi_tpu/train/optim.py``).

SGD with momentum 0.9 over all parameters, BN included. Weight decay is
coupled into the gradient before the momentum buffer
(``d = g + wd * p; buf = mu * buf + d; p -= lr * buf``), which is exactly
``torch.optim.SGD(momentum=mu, weight_decay=wd)``. The LR follows the
reference's gradual warmup, stepped per epoch. The generic schedulers
below (``GradualWarmupChain``, ``ReduceOnPlateau`` and
``GradualWarmupPlateau``) are the JAX package's copies of the reference's
scheduler surface.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


def warmup_lr(epoch: int, base_lr: float, multiplier: float,
              warmup_epochs: int, use_warmup: bool = True) -> float:
    """LR used during ``epoch`` (scheduler value after ``epoch`` steps)."""
    if not use_warmup or warmup_epochs <= 0:
        return base_lr
    e = min(epoch, warmup_epochs)
    return base_lr * (1.0 + (multiplier - 1.0) * e / warmup_epochs)


def make_optimizer(model: torch.nn.Module, base_lr: float,
                   weight_decay: float):
    return torch.optim.SGD(model.parameters(), lr=base_lr, momentum=0.9,
                           weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# Generic gradual-warmup chaining (``selavi_tpu/train/optim.py:66-214``,
# after the reference's warmup_scheduler.py): epoch-indexed schedules as
# pure functions and explicit state, not objects that mutate an optimizer.


@dataclasses.dataclass(frozen=True)
class GradualWarmupChain:
    """Epoch-indexed LR: gradual warmup, then an arbitrary after-schedule.

    During epochs ``<= total_epoch`` the LR ramps (from 0 when
    ``multiplier == 1``, else from ``base_lr`` toward ``base_lr *
    multiplier``); afterwards ``after(shifted_epoch)`` (a factor, e.g.
    ``multistep_factor``) scales ``base_lr * multiplier``."""

    base_lr: float
    multiplier: float = 1.0
    total_epoch: int = 10
    after: Optional[Callable[[int], float]] = None

    def __post_init__(self):
        if self.multiplier < 1.0:
            raise ValueError("multiplier should be >= 1.")

    def lr(self, epoch: int) -> float:
        if epoch > self.total_epoch:
            target = self.base_lr * self.multiplier
            if self.after is not None:
                return target * self.after(epoch - self.total_epoch)
            return target
        if self.multiplier == 1.0:
            return self.base_lr * (float(epoch) / self.total_epoch)
        return self.base_lr * (
            (self.multiplier - 1.0) * epoch / self.total_epoch + 1.0)


def multistep_factor(milestones, gamma: float) -> Callable[[int], float]:
    """torch's MultiStepLR as a pure factor function (for ``after=``)."""
    ms = sorted(milestones)

    def factor(epoch: int) -> float:
        return gamma ** sum(1 for m in ms if m <= epoch)

    return factor


class PlateauState(NamedTuple):
    """ReduceOnPlateau's state (torch mutates the same fields in place)."""

    best: float
    num_bad_epochs: int
    cooldown_counter: int
    factor: float  # product of the gamma reductions so far


@dataclasses.dataclass(frozen=True)
class ReduceOnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau's rule as a pure step:
    ``mode`` min/max, relative or absolute ``threshold``, a ``gamma``
    reduction after more than ``patience`` bad epochs, ``cooldown`` epochs
    after a reduction, the factor floored at ``min_factor``."""

    mode: str = "min"
    gamma: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_factor: float = 0.0

    def init(self) -> PlateauState:
        best = float("inf") if self.mode == "min" else float("-inf")
        return PlateauState(best, 0, 0, 1.0)

    def _is_better(self, metric: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < best * (1.0 - self.threshold)
            return metric < best - self.threshold
        if self.threshold_mode == "rel":
            return metric > best * (1.0 + self.threshold)
        return metric > best + self.threshold

    def step(self, state: PlateauState, metric: float) -> PlateauState:
        best, bad, cool, factor = state
        if self._is_better(metric, best):
            best, bad = metric, 0
        else:
            bad += 1
        if cool > 0:
            cool -= 1
            bad = 0  # bad epochs do not count during cooldown
        if bad > self.patience:
            factor = max(factor * self.gamma, self.min_factor)
            cool = self.cooldown
            bad = 0
        return PlateauState(best, bad, cool, factor)


@dataclasses.dataclass(frozen=True)
class GradualWarmupPlateau:
    """Gradual warmup chained into ReduceOnPlateau, stepped at the end of
    an epoch with its metric: epoch 0 counts as 1, epochs ``<=
    total_epoch`` take the warmup's multiplier form (at multiplier 1 too),
    later ones the plateau rule on the shifted sequence."""

    base_lr: float
    multiplier: float = 1.0
    total_epoch: int = 10
    plateau: ReduceOnPlateau = ReduceOnPlateau()

    def init(self) -> PlateauState:
        return self.plateau.init()

    def step(self, state: PlateauState, metric: float,
             epoch: int) -> tuple[PlateauState, float]:
        """Returns (new state, the LR of the NEXT epoch)."""
        epoch = epoch if epoch != 0 else 1
        if epoch <= self.total_epoch:
            lr = self.base_lr * (
                (self.multiplier - 1.0) * epoch / self.total_epoch + 1.0)
            return state, lr
        state = self.plateau.step(state, metric)
        return state, self.base_lr * self.multiplier * state.factor
