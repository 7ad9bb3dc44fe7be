"""What the reference reads: samples of the benchmark's shard, the order
and crops in which a training run reads them, and the preprocessing on
the card (YUV 4:2:0 to RGB, flips, normalisation, the log-mel
spectrogram), in plain numpy and PyTorch.

The order and crops follow the loader's documented rules: an epoch's
order is ``default_rng((seed, epoch)).permutation(N)``, sample ``i`` of an
epoch draws from ``default_rng((seed, epoch, i))``, and a shard's frames
are cropped at even offsets ``2 * integers(0, (S - c) // 2 + 1)`` (rows,
then columns). The benchmark serves sample ``i`` from shard record
``i mod R``. The per-clip draws of a step come from one generator on the
card, in a fixed order: flip, brightness, contrast, saturation, jitter
order, jitter on, grayscale on (``draw_augmentations``).
"""

from __future__ import annotations

import functools
import json
import math
import struct

import numpy as np
import torch

MAGIC = b"SLVPACK1"


class Shard:
    """The records of a packed shard, read with ``numpy.memmap``."""

    def __init__(self, path):
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"not a packed shard: {path}")
            (hlen,) = struct.unpack("<I", f.read(4))
            self.meta = json.loads(f.read(hlen))
        off = len(MAGIC) + 4 + hlen
        t, s, _, _ = self.meta["video_shape"]
        if self.meta["video_format"] != "yuv420" or (
                self.meta["pcm_dtype"] != "int16"):
            raise ValueError("the reference reads yuv420 / int16 shards")
        self.t, self.s, self.pcm_len = t, s, self.meta["pcm_len"]
        self.n = self.meta["n"]
        self.record = np.dtype([
            ("y", np.uint8, (t, s, s)),
            ("uv", np.uint8, (t, s // 2, s // 2, 2)),
            ("pcm", "<i2", (self.pcm_len,)),
            ("label", "<i4"),
        ])
        self.data = np.memmap(path, self.record, "r", off, (self.n,))


def epoch_order(n, seed, epoch=0, shuffle=True):
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng((seed, epoch)).permutation(n)


def read_batch(shard, indices, crop, seed, epoch=0, samples=None):
    """The wire-format batch of dataset samples ``indices``: y [B,T,c,c],
    uv [B,T,c/2,c/2,2] uint8 and pcm [B,S] int16, each sample cropped with
    its own draw. ``samples`` is the number of seconds times the sample
    rate that the clip keeps (the shard's whole waveform by default)."""
    want = samples or shard.pcm_len
    ys, uvs, pcms = [], [], []
    for i in indices:
        rec = shard.data[int(i) % shard.n]
        rng = np.random.default_rng((seed, epoch, int(i)))
        i0 = j0 = 0
        if crop < shard.s:
            i0 = 2 * int(rng.integers(0, (shard.s - crop) // 2 + 1))
            j0 = 2 * int(rng.integers(0, (shard.s - crop) // 2 + 1))
        ys.append(rec["y"][:, i0:i0 + crop, j0:j0 + crop])
        uvs.append(rec["uv"][:, i0 // 2:(i0 + crop) // 2,
                             j0 // 2:(j0 + crop) // 2])
        slack = shard.pcm_len - want
        start = int(rng.integers(0, slack + 1)) if slack > 0 else 0
        pcms.append(rec["pcm"][start:start + want])
    return np.stack(ys), np.stack(uvs), np.stack(pcms)


def yuv420_to_rgb(y, uv):
    """BT.601 full range, nearest chroma upsampling, rounded half to even
    and clipped: uint8 [B,T,H,W,3]."""
    y = y.float()
    uv = uv.float() - 128.0
    uv = uv.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    u, v = uv[..., 0], uv[..., 1]
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v,
                       y + 1.772 * u], dim=-1)
    return torch.round(rgb).clamp_(0.0, 255.0).to(torch.uint8)


def draw_augmentations(b, generator):
    """The per-clip draws of one batch, in the order they are made."""
    dev = generator.device
    rand = functools.partial(torch.rand, b, generator=generator, device=dev)
    draws = {"flip": rand() < 0.5}
    for key in ("bf", "cf", "sf"):
        draws[key] = rand() * 0.8 + 0.6
    draws["perm_idx"] = torch.randint(0, 6, (b,), generator=generator,
                                      device=dev)
    draws["jitter"] = rand() < 0.8
    draws["gray"] = rand() < 0.2
    return draws


def augment(frames_u8, draws):
    """Flip where drawn, then ``(x / 255 - 0.45) / 0.225``: float32
    [B,T,H,W,3]. (The recipe turns colour jitter and grayscale off.)"""
    x = frames_u8.float() / 255.0
    x = torch.where(draws["flip"][:, None, None, None, None], x.flip(3), x)
    return (x - 0.45) / 0.225


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(nfilt, nfft, samplerate):
    """Triangular mel filters [nfilt, nfft//2 + 1] from 0 Hz to Nyquist
    (python_speech_features' ``get_filterbanks``)."""
    points = np.linspace(_hz2mel(0.0), _hz2mel(samplerate / 2.0), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(points) / samplerate).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb


def logfbank(pcm, samplerate=48000, nfilt=257, nfft=1024):
    """python_speech_features' ``logfbank`` (preemphasis 0.97, 20 ms
    frames every 10 ms, zero padded, ``|rfft|^2 / nfft``, mel filters,
    log floored at float64 eps) of PCM [B, S]: [B, nfilt, frames, 1]
    float32 (computed in float64)."""
    x = pcm.double()
    x = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
    flen = int(math.floor(0.02 * samplerate + 0.5))
    step = int(math.floor(0.01 * samplerate + 0.5))
    slen = x.shape[1]
    frames = 1 if slen <= flen else 1 + math.ceil((slen - flen) / step)
    x = torch.nn.functional.pad(x, (0, (frames - 1) * step + flen - slen))
    spec = torch.fft.rfft(x.unfold(1, flen, step), n=nfft, dim=-1)
    power = spec.abs() ** 2 / nfft
    fb = torch.tensor(mel_filterbank(nfilt, nfft, samplerate).T,
                      dtype=torch.float64, device=pcm.device)
    feat = power @ fb
    feat = torch.where(feat == 0, torch.finfo(torch.float64).eps, feat)
    return torch.log(feat).transpose(1, 2)[..., None].float()
