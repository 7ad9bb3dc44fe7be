"""Training meters: the port's copy of ``selavi_tpu/utils/meters.py``'s
``AverageMeter`` (the one meter the Trainer uses)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
