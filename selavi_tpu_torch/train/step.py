"""Training and inference steps (``selavi_tpu/train/step.py``).

A train step: augment the uint8 clips on the device, forward both towers
and heads in train mode, ``loss = 0.5 * CE_v + 0.5 * CE_a`` (each the mean
over heads of the fp32 cross-entropy), backward, SGD step. Compute runs
under bf16 autocast when ``compute_dtype`` is bfloat16 (the default on the
card) and in fp32 otherwise.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from selavi_tpu_torch.ops.preprocess import augment_video_batch, normalize_video


def autocast(device: torch.device, compute_dtype: torch.dtype):
    """bf16/fp16 autocast; any other dtype runs in the parameters' dtype."""
    if compute_dtype in (torch.bfloat16, torch.float16):
        return torch.autocast(device_type=device.type, dtype=compute_dtype)
    return contextlib.nullcontext()


def multihead_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over heads of CE(logits[h], labels[:, h]); logits [H, B, K],
    labels [B, H] int. Computed in fp32."""
    h, b, k = logits.shape
    return F.cross_entropy(logits.float().reshape(h * b, k),
                           labels.t().reshape(h * b).long())


def make_train_step(model, optimizer, colorjitter: bool = False,
                    grayscale: bool = False,
                    compute_dtype: torch.dtype = torch.float32):
    """Returns ``step(batch, labels, generator) -> metrics`` (0-dim tensors,
    not synced). ``batch['video']`` uint8 [B,T,H,W,3] and
    ``batch['audio']`` fp32 [B,F,T,1] on the device; ``labels`` [B, H]."""
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    def step(batch, labels, generator):
        model.train()
        video = augment_video_batch(batch["video"], generator,
                                    colorjitter=colorjitter,
                                    grayscale=grayscale, flip=True,
                                    dtype=dtype)
        with autocast(device, compute_dtype):
            logits_v, logits_a = model(video, batch["audio"].to(dtype),
                                       generator=generator)
            loss_v = multihead_ce(logits_v, labels)
            loss_a = multihead_ce(logits_a, labels)
            loss = 0.5 * loss_v + 0.5 * loss_a
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "loss_v": loss_v.detach(),
                "loss_a": loss_a.detach()}

    return step


@torch.no_grad()
def bn_warmup_step(model, video_u8, audio, generator,
                   compute_dtype: torch.dtype = torch.float32):
    """Forward-only train-mode pass (heads included) that updates the BN
    running statistics."""
    device = video_u8.device
    model.train()
    video = augment_video_batch(video_u8, generator, flip=True)
    with autocast(device, compute_dtype):
        model(video, audio, generator=generator)


@torch.no_grad()
def encode(model, video_u8, audio, generator=None, augment: bool = True,
           colorjitter: bool = False, grayscale: bool = False,
           compute_dtype: torch.dtype = torch.float32):
    """Eval-mode pooled features ``(feat_v, feat_a)`` for SK aggregation.
    ``augment`` runs the train-time flip (and jitter/grayscale when set);
    otherwise the video is only normalized."""
    device = video_u8.device
    model.eval()
    if augment:
        video = augment_video_batch(video_u8, generator,
                                    colorjitter=colorjitter,
                                    grayscale=grayscale, flip=True)
    else:
        video = normalize_video(video_u8)
    with autocast(device, compute_dtype):
        return model(video, audio, return_features=True)


@torch.no_grad()
def head_logits(model, feats, modality: str,
                compute_dtype: torch.dtype = torch.float32):
    """``feats [N, D] -> [H, N, K]`` through every head, eval mode."""
    model.eval()
    with autocast(feats.device, compute_dtype):
        heads = model.video_heads if modality == "v" else model.audio_heads
        return heads(feats)
