"""Action-recognition finetuning on UCF-101 / HMDB-51
(``selavi_tpu/eval/finetune.py``).

* ``FinetuneModel``: the pretrained R(2+1)D-18 tower (``base``), an
  optional L2 norm, BatchNorm (``final_bn``) and Dropout(0.7), and an
  orthogonally initialised ``classifier``;
* ``make_finetune_optimizer``: two param groups, the classifier at
  ``head_lr``/``weight_decay`` and the tower at ``base_lr``/``wd_base``;
  ``final_bn``'s affine parameters are in neither (frozen), and the tower
  is frozen too under ``feature_extract``. A frozen module still updates
  its BN running statistics in train mode, as in JAX. SGD with momentum
  and Adam both couple the weight decay into the gradient
  (``torch.optim.SGD``/``Adam`` with ``weight_decay``, not AdamW);
* the LR factor ``finetune_lr_factor`` (GradualWarmup x8, then MultiStepLR
  on shifted milestones), read from a per-epoch table at ``step //
  batches_per_epoch`` before every step (``set_finetune_lr``), so a resumed
  run continues mid-schedule;
* ``make_finetune_steps``: the train step (flip on the card, bf16 autocast
  on request, fp32 cross-entropy, one optimizer step) and the eval step;
* ``evaluate``: clip loss and acc@1, video acc@1/acc@5 from the mean of
  each video's clip logits.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.models.common import FlaxBatchNorm
from selavi_tpu_torch.models.heads import dropout
from selavi_tpu_torch.models.r2plus1d import VIDEO_FEATURE_DIM, R2Plus1D18
from selavi_tpu_torch.ops.preprocess import (
    augment_video_batch,
    normalize_video,
)
from selavi_tpu_torch.train.step import autocast
from selavi_tpu_torch.utils.meters import (
    AverageMeter,
    aggregate_video_accuracy,
    topk_accuracy,
)

logger = logging.getLogger(__name__)

NUM_CLASSES = {"hmdb51": 51, "ucf101": 101}
DROPOUT_RATE = 0.7


class FinetuneModel(nn.Module):
    """Video tower + classifier head (the reference's Finetune_Model).
    ``forward(video [B,T,H,W,3]) -> logits [B, num_classes]``; train-mode
    dropout draws from the ``generator`` argument. The head (norm, BN,
    classifier) runs in fp32 outside any autocast, as JAX's does."""

    def __init__(self, num_classes: int, use_dropout: bool = False,
                 use_bn: bool = False, use_l2_norm: bool = False,
                 midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.use_dropout = use_dropout
        self.use_l2_norm = use_l2_norm
        self.base = R2Plus1D18(midplanes_mode, g)
        self.final_bn = FlaxBatchNorm(VIDEO_FEATURE_DIM) if use_bn else None
        self.classifier = nn.Linear(VIDEO_FEATURE_DIM, num_classes)
        with torch.no_grad():
            nn.init.orthogonal_(self.classifier.weight, generator=g)
            self.classifier.bias.zero_()

    def forward(self, video, generator: Optional[torch.Generator] = None):
        x = self.base(video)  # fp32 [B, 512]
        with torch.autocast(x.device.type, enabled=False):
            x = x.to(self.classifier.weight.dtype)
            if self.use_l2_norm:
                x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
            if self.final_bn is not None:
                x = self.final_bn(x)
            if self.use_dropout and self.training:
                x = dropout(x, DROPOUT_RATE, generator)
            return self.classifier(x)


def finetune_lr_factor(epoch: int, warmup_epochs: int,
                       milestones: tuple[int, ...], gamma: float,
                       multiplier: float = 8.0,
                       use_scheduler: bool = True) -> float:
    """LR multiplier at ``epoch`` relative to the group's base LR
    (GradualWarmup x multiplier, then MultiStepLR on shifted milestones)."""
    if not use_scheduler:
        return 1.0
    if warmup_epochs > 0:
        if epoch <= warmup_epochs:
            return 1.0 + (multiplier - 1.0) * epoch / warmup_epochs
        shifted = [m - warmup_epochs for m in milestones]
        k = sum(1 for m in shifted if m <= epoch - warmup_epochs)
        return multiplier * (gamma ** k)
    k = sum(1 for m in milestones if m <= epoch)
    return gamma ** k


@dataclasses.dataclass
class FinetuneConfig:
    num_classes: int = 101
    head_lr: float = 0.0025
    base_lr: float = 0.00025
    weight_decay: float = 0.005
    wd_base: float = 5e-3
    momentum: float = 0.9
    optim_name: str = "sgd"
    feature_extract: bool = False
    use_dropout: bool = False
    use_bn: bool = False
    use_l2_norm: bool = False
    lr_warmup_epochs: int = 2
    lr_milestones: tuple[int, ...] = (6, 10)
    lr_gamma: float = 0.05
    use_scheduler: bool = True
    epochs: int = 12


def lr_factor_table(cfg: FinetuneConfig) -> np.ndarray:
    """``finetune_lr_factor`` for epochs ``0..cfg.epochs`` as float32, as
    JAX tabulates it."""
    return np.asarray([
        finetune_lr_factor(e, cfg.lr_warmup_epochs, cfg.lr_milestones,
                           cfg.lr_gamma, use_scheduler=cfg.use_scheduler)
        for e in range(cfg.epochs + 1)], np.float32)


def make_finetune_optimizer(cfg: FinetuneConfig,
                            model: FinetuneModel) -> torch.optim.Optimizer:
    """Two param groups, ``head`` (the classifier) and ``base`` (the tower,
    absent under ``feature_extract``), each keeping its base LR as
    ``base_lr``. Parameters in no group (``final_bn``'s, and the tower's
    under ``feature_extract``) get ``requires_grad=False``."""
    groups = [{"name": "head", "params": list(model.classifier.parameters()),
               "lr": cfg.head_lr, "base_lr": cfg.head_lr,
               "weight_decay": cfg.weight_decay}]
    if cfg.feature_extract:
        model.base.requires_grad_(False)
    else:
        groups.append({"name": "base", "params": list(model.base.parameters()),
                       "lr": cfg.base_lr, "base_lr": cfg.base_lr,
                       "weight_decay": cfg.wd_base})
    if model.final_bn is not None:
        model.final_bn.requires_grad_(False)
    if cfg.optim_name == "adam":
        return torch.optim.Adam(groups)
    return torch.optim.SGD(groups, momentum=cfg.momentum)


def set_finetune_lr(optimizer: torch.optim.Optimizer, table: np.ndarray,
                    step: int, batches_per_epoch: int) -> None:
    """Every group's LR for optimizer step ``step`` (0-based): its base LR
    times the table's factor at ``step // batches_per_epoch``, clipped to
    the table, computed in float32 as JAX's schedule does."""
    epoch = min(max(step // max(batches_per_epoch, 1), 0), len(table) - 1)
    for group in optimizer.param_groups:
        group["lr"] = float(np.float32(group["base_lr"]) * table[epoch])


def make_finetune_steps(model: FinetuneModel,
                        optimizer: torch.optim.Optimizer,
                        compute_dtype: torch.dtype = torch.float32):
    """Returns ``(train_step, train_step_on, eval_step)``.

    ``train_step(video_u8, labels, generator)`` flips the uint8 clips on
    their device and calls ``train_step_on(video, labels, generator)``,
    which takes a normalized batch: the forward in train mode (under
    autocast for bf16/fp16), the fp32 cross-entropy, backward and one
    optimizer step; both return ``(loss, logits)``. ``eval_step(video_u8,
    labels)`` normalizes and returns ``(logits, loss)`` in eval mode."""
    param = next(model.parameters())
    dtype = param.dtype

    def train_step_on(video, labels, generator=None):
        model.train()
        with autocast(video.device, compute_dtype):
            logits = model(video, generator=generator)
        loss = F.cross_entropy(logits.float(), labels.long())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), logits.detach()

    def train_step(video_u8, labels, generator):
        video = augment_video_batch(video_u8, generator, flip=True,
                                    dtype=dtype)
        return train_step_on(video, labels, generator)

    @torch.no_grad()
    def eval_step(video_u8, labels):
        model.eval()
        video = normalize_video(video_u8, dtype)
        with autocast(video.device, compute_dtype):
            logits = model(video)
        loss = F.cross_entropy(logits.float(), labels.long())
        return logits, loss

    return train_step, train_step_on, eval_step


def evaluate(eval_step: Callable, loader, writer=None, epoch: int = 0,
             ds: str = "hmdb51") -> tuple[float, float, float]:
    """Clip-level loss, video-level acc@1/acc@5 over ``loader``'s batches
    (rows deduplicated by the batch ``index``). As in JAX, a video's score
    is the mean of its clips' raw logits."""
    losses, top1 = AverageMeter(), AverageMeter()
    clip_logits: dict = {}
    labels_by_vid: dict = {}
    seen: set = set()
    for batch in loader:
        labels = batch["label"].cpu().numpy()
        logits, loss = eval_step(batch["video"], batch["label"])
        logits = logits.float().cpu().numpy()
        losses.update(float(loss), len(logits))
        acc1, _ = topk_accuracy(logits, labels, (1, 5))
        top1.update(acc1, len(logits))
        vids = batch["vid_idx"].cpu().numpy()
        idxs = batch["index"].cpu().numpy() if "index" in batch else None
        for j, vid in enumerate(vids):
            if idxs is not None:
                if int(idxs[j]) in seen:
                    continue
                seen.add(int(idxs[j]))
            clip_logits.setdefault(int(vid), []).append(logits[j])
            labels_by_vid[int(vid)] = int(labels[j])
    vid_acc1, vid_acc5 = aggregate_video_accuracy(
        clip_logits, labels_by_vid, topk=(1, 5))
    logger.info("Test: Loss %.4f ClipAcc@1 %.3f VidAcc@1 %.3f", losses.avg,
                top1.avg, vid_acc1)
    if writer:
        writer.add_scalar(f"{ds}/val/vid_acc1/epoch", vid_acc1, epoch)
        writer.add_scalar(f"{ds}/val/vid_acc5/epoch", vid_acc5, epoch)
    return losses.avg, float(vid_acc1), float(vid_acc5)
