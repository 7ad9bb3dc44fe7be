"""Optimizer and LR schedule (``selavi_tpu/train/optim.py``).

SGD with momentum 0.9 over all parameters, BN included. Weight decay is
coupled into the gradient before the momentum buffer
(``d = g + wd * p; buf = mu * buf + d; p -= lr * buf``), which is exactly
``torch.optim.SGD(momentum=mu, weight_decay=wd)``. The LR follows the
reference's gradual warmup, stepped per epoch.
"""

from __future__ import annotations

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
