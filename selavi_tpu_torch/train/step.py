"""Training and inference steps (``selavi_tpu/train/step.py``).

A train step: augment the uint8 clips on the device, forward both towers
and heads in train mode, ``loss = 0.5 * CE_v + 0.5 * CE_a`` (each the mean
over heads of the fp32 cross-entropy), backward, SGD step. Compute runs
under bf16 autocast when ``compute_dtype`` is bfloat16 (the default on the
card) and in fp32 otherwise.

Audio arrives as spectrograms ``[B,F,T,1]`` or, with
``--device_spectrogram``, as raw PCM ``[B,S]`` that ``prepare_audio``
turns into spectrograms on the device (``ops/logmel.py``), in fp32 and
outside autocast. With ``--dual_data`` (``video_clips=2``) a sample holds
two clips concatenated along time, each augmented with its own draws, and
its audio two channels.

Under data parallelism (``shard = (rank, world)``) every rank draws the
flips, jitters and dropout masks of the global batch from the generator
that all ranks seed alike, and keeps its rows ``rank::world``: a
``world``-rank step sees the draws of the one-rank step at ``world`` times
the batch. ``model`` may be a ``DistributedDataParallel`` wrapper.

On a process grid with ``M > 1`` (``grid``, ``parallel/mesh.py``) a rank's
logits are its ``H / M`` heads' on its data row's gathered rows: the step
gathers the rows' labels over the model group and takes the owned heads'
columns, and its CE sums the owned heads and divides by the global ``H``,
so that the ranks' losses summed over a data row make the row's loss.
``model`` is then ``mesh.GridParallel``: the heads' gradients are averaged
over the data group, the towers' over all ranks (the gather's backward
scales their gradient by ``M``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from selavi_tpu_torch.ops.logmel import logfbank_batch
from selavi_tpu_torch.ops.preprocess import augment_video_batch, normalize_video
from selavi_tpu_torch.parallel import mesh
from selavi_tpu_torch.utils.profiling import span


def autocast(device: torch.device, compute_dtype: torch.dtype):
    """bf16/fp16 autocast; any other dtype runs in the parameters' dtype."""
    if compute_dtype in (torch.bfloat16, torch.float16):
        return torch.autocast(device_type=device.type, dtype=compute_dtype)
    return contextlib.nullcontext()


def prepare_audio(audio: torch.Tensor, dtype: torch.dtype = torch.float32,
                  audio_cfg: Optional[dict] = None) -> torch.Tensor:
    """Spectrograms ``[B,F,T,C]`` pass through (cast to ``dtype``); raw PCM
    ``[B,S]`` becomes ``[B,F,T,1]``, and dual-clip PCM ``[B,n,S]`` (n <= 4)
    an n-channel spectrogram ``[B,F,T,n]`` (the reference stacks dual specs
    along the channel axis, AVideoDataset.py:451). ``audio_cfg`` holds
    ``samplerate``, ``nfilt`` and ``z_normalize``
    (``data/factory.py::audio_cfg_from_args``)."""
    if audio.ndim == 2 or (audio.ndim == 3 and audio.shape[1] <= 4):
        cfg = audio_cfg or {}
        clips = audio.shape[1] if audio.ndim == 3 else None
        pcm = audio.reshape(-1, audio.shape[-1])
        spec = logfbank_batch(pcm, samplerate=cfg.get("samplerate", 48000),
                              nfilt=cfg.get("nfilt", 257),
                              z_normalize=cfg.get("z_normalize", False))
        if clips is None:
            return spec[..., None].to(dtype)
        spec = spec.reshape(audio.shape[0], clips, *spec.shape[1:])
        return spec.movedim(1, -1).to(dtype)  # [B, F, T, n]
    return audio.to(dtype)


def multihead_ce(logits: torch.Tensor, labels: torch.Tensor,
                 headcount: Optional[int] = None) -> torch.Tensor:
    """Sum over heads of CE(logits[h], labels[:, h]) divided by
    ``headcount`` (by default the logits' own ``h``: their mean); logits
    [h, B, K], labels [B, h] int. Computed in fp32, or fp64 for fp64
    logits, so that an fp64 run's loss and gradients do not depend on how
    the heads and rows are grouped to the last bits of fp32."""
    h, b, k = logits.shape
    dtype = torch.promote_types(logits.dtype, torch.float32)
    ce = F.cross_entropy(logits.to(dtype).reshape(h * b, k),
                         labels.t().reshape(h * b).long())
    return ce if headcount in (None, h) else ce * (h / headcount)


def head_labels(labels: torch.Tensor, grid=None) -> torch.Tensor:
    """``labels [B, H]`` of this rank's rows as its logits cover them: on a
    grid with ``M > 1`` its data row's rows (gathered over the model group
    in ``Grid.gather``'s order) at the owned heads' columns."""
    if grid is None or grid.model_size == 1:
        return labels
    first, count = grid.heads(labels.shape[1])
    rows = mesh.gather_rows(labels, group=grid.model_group)
    return rows[:, first:first + count]


def make_train_step(model, optimizer, colorjitter: bool = False,
                    grayscale: bool = False,
                    compute_dtype: torch.dtype = torch.float32,
                    audio_cfg: Optional[dict] = None, video_clips: int = 1,
                    shard: tuple[int, int] = (0, 1), grid=None):
    """Returns ``step(batch, labels, generator) -> metrics`` (0-dim tensors,
    not synced; the loss is this rank's, on a grid over its heads: see the
    module docstring). ``batch['video']`` uint8
    [B,T,H,W,3] and ``batch['audio']`` fp32 [B,F,T,1] (or
    ``batch['audio_pcm']`` [B,S], turned into spectrograms by
    ``prepare_audio``) on the device; ``labels`` [B, H]. ``video_clips`` >
    1 (dual_data) gives each time-concatenated clip its own flip and
    jitter; ``shard`` as in the module docstring. Its stages are the
    spans ``train.input`` (augmentation, log-mel), ``train.forward``
    (model and losses), ``train.backward`` (with DDP's all-reduces) and
    ``train.optimizer`` (``utils/profiling.py``)."""
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    def step(batch, labels, generator):
        model.train()
        with span("train.input"):
            video = augment_video_batch(batch["video"], generator,
                                        colorjitter=colorjitter,
                                        grayscale=grayscale, flip=True,
                                        dtype=dtype, clips=video_clips,
                                        shard=shard)
            audio = prepare_audio(batch.get("audio", batch.get("audio_pcm")),
                                  dtype, audio_cfg)
        headcount = labels.shape[1]
        labels = head_labels(labels, grid)
        with span("train.forward"), autocast(device, compute_dtype):
            logits_v, logits_a = model(video, audio, generator=generator,
                                       shard=shard)
            loss_v = multihead_ce(logits_v, labels, headcount)
            loss_a = multihead_ce(logits_a, labels, headcount)
            loss = 0.5 * loss_v + 0.5 * loss_a
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("train.optimizer"):
            optimizer.step()
        return {"loss": loss.detach(), "loss_v": loss_v.detach(),
                "loss_a": loss_a.detach()}

    return step


@torch.no_grad()
def bn_warmup_step(model, video_u8, audio, generator,
                   compute_dtype: torch.dtype = torch.float32,
                   audio_cfg: Optional[dict] = None, video_clips: int = 1,
                   shard: tuple[int, int] = (0, 1)):
    """Forward-only train-mode pass (heads included, on a grid the owned
    heads on the gathered rows) that updates the BN running statistics."""
    device = video_u8.device
    model.train()
    video = augment_video_batch(video_u8, generator, flip=True,
                                clips=video_clips, shard=shard)
    audio = prepare_audio(audio, next(model.parameters()).dtype, audio_cfg)
    with autocast(device, compute_dtype):
        model(video, audio, generator=generator, shard=shard)


def match_audio_channels(spec: torch.Tensor,
                         audio_channels: Optional[int]) -> torch.Tensor:
    """Tile a one-channel spectrogram ``[..., 1]`` to the audio stem's
    channel count (``selavi_tpu/train/step.py::_match_audio_channels``):
    a dual_data checkpoint has a 2-channel stem, and evaluation datasets
    yield single clips."""
    if audio_channels and spec.shape[-1] == 1 and audio_channels != 1:
        spec = spec.expand(*spec.shape[:-1], int(audio_channels))
    return spec


@torch.no_grad()
def encode(model, video_u8, audio, generator=None, augment: bool = True,
           colorjitter: bool = False, grayscale: bool = False,
           compute_dtype: torch.dtype = torch.float32,
           audio_cfg: Optional[dict] = None,
           audio_channels: Optional[int] = None, video_clips: int = 1,
           shard: tuple[int, int] = (0, 1)):
    """Eval-mode pooled features ``(feat_v, feat_a)`` for SK aggregation.
    ``augment`` runs the train-time flip (and jitter/grayscale when set;
    per clip with ``video_clips`` > 1); otherwise the video is only
    normalized. PCM ``audio`` goes through ``prepare_audio``; a one-channel
    spectrogram is tiled to ``audio_channels``."""
    device = video_u8.device
    model.eval()
    if augment:
        video = augment_video_batch(video_u8, generator,
                                    colorjitter=colorjitter,
                                    grayscale=grayscale, flip=True,
                                    clips=video_clips, shard=shard)
    else:
        video = normalize_video(video_u8)
    audio = match_audio_channels(
        prepare_audio(audio, next(model.parameters()).dtype, audio_cfg),
        audio_channels)
    with autocast(device, compute_dtype):
        return model(video, audio, return_features=True)


@torch.no_grad()
def head_logits(model, feats, modality: str,
                compute_dtype: torch.dtype = torch.float32):
    """``feats [N, D] -> [h, N, K]`` through every head the model holds
    (on a grid its owned heads), eval mode."""
    model.eval()
    with autocast(feats.device, compute_dtype):
        heads = model.video_heads if modality == "v" else model.audio_heads
        return heads(feats)
