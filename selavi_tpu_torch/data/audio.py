"""Audio frontend: waveform -> log filterbank spectrogram (numpy).

The port's copy of ``selavi_tpu/data/audio.py`` (the reference's
datasets/audio_utils.py:14-112): clip slicing at the clip's start second
(clamped to the file), temporal jitter (+-0.5 s) and volume jitter
(x U(0.9, 1.1)) drawn from the caller's rng in the JAX package's order,
and the python_speech_features log filterbank (preemphasis 0.97,
zero-padded rectangular framing with ``winlen=0.02, winstep=0.01,
nfft=1024``, ``|rfft|^2 / nfft`` power spectrum, triangular mel filters,
eps-floored log) with ``nfilt`` 40 (spec type 1) or 257 (spec type 2),
transposed to ``[nfilt, T]`` (T = 99 frames per second), optional
z-normalization ``(x - 1.93) / 17.89``.

The host computes the filterbank in numpy float64 here; the JAX package
uses its C++ data runtime when built, which the port has not yet (ROADMAP
Queue 1 item 4). With ``--device_spectrogram`` the host only slices and
jitters the waveform (``slice_clip_pcm``) and the card computes the
spectrogram (``selavi_tpu_torch.ops.logmel``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(nfilt: int, nfft: int, samplerate: int) -> np.ndarray:
    """Triangular mel filterbank [nfilt, nfft//2 + 1] from 0 Hz to Nyquist,
    cached per configuration (read-only: callers must not write to it)."""
    lowmel, highmel = hz2mel(0.0), hz2mel(samplerate / 2.0)
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / samplerate).astype(int)

    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    fbank.flags.writeable = False
    return fbank


def frame_count(slen: int, frame_len: int, frame_step: int) -> int:
    if slen <= frame_len:
        return 1
    return 1 + int(math.ceil((1.0 * slen - frame_len) / frame_step))


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def frame_signal(signal: np.ndarray, frame_len: int,
                 frame_step: int) -> np.ndarray:
    """Zero-padded overlapping frames [num_frames, frame_len]."""
    slen = len(signal)
    numframes = frame_count(slen, frame_len, frame_step)
    padlen = (numframes - 1) * frame_step + frame_len
    padded = np.concatenate(
        [signal, np.zeros(padlen - slen, dtype=signal.dtype)]
    )
    idx = (np.arange(frame_len)[None, :]
           + np.arange(numframes)[:, None] * frame_step)
    return padded[idx]


def preemphasis(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    return np.concatenate([signal[:1], signal[1:] - coeff * signal[:-1]])


def logfbank(signal: np.ndarray, samplerate: int = 16000,
             winlen: float = 0.02, winstep: float = 0.01, nfilt: int = 40,
             nfft: int = 1024, preemph: float = 0.97) -> np.ndarray:
    """Log mel filterbank energies, shape [num_frames, nfilt]."""
    signal = preemphasis(np.asarray(signal, np.float64), preemph)
    frames = frame_signal(signal, _round_half_up(winlen * samplerate),
                          _round_half_up(winstep * samplerate))
    pspec = (1.0 / nfft) * np.abs(np.fft.rfft(frames, nfft)) ** 2
    feat = pspec @ mel_filterbank(nfilt, nfft, samplerate).T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat)


def _clip_window(wav: np.ndarray, fr_sec: float, num_sec: int,
                 sample_rate: int) -> np.ndarray:
    """Exactly ``num_sec * sample_rate`` samples starting near ``fr_sec``,
    clamped into the waveform and zero-padded at the tail."""
    target = int(sample_rate * num_sec)
    fr_aud = max(int(np.round(fr_sec * sample_rate)), 0)
    if fr_aud + target > len(wav):
        fr_aud = max(len(wav) - target, 0)
    clip = wav[fr_aud : fr_aud + target]
    if len(clip) < target:
        clip = np.concatenate([clip, np.zeros(target - len(clip), clip.dtype)])
    return clip


def get_spec(wav: np.ndarray, fr_sec: float, num_sec: int = 1,
             sample_rate: int = 48000, aud_spec_type: int = 1,
             use_volume_jittering: bool = False,
             use_temporal_jittering: bool = False,
             z_normalize: bool = False,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Slice + augment + spectrogram. Returns [1, nfilt, T] float32."""
    if rng is None:
        rng = np.random.default_rng()
    if use_temporal_jittering:
        fr_sec = fr_sec + rng.uniform(-0.5, 0.5)
    wav = _clip_window(wav, fr_sec, num_sec, sample_rate)
    if use_volume_jittering:
        wav = wav * rng.uniform(0.9, 1.1)
    nfilt = 40 if aud_spec_type == 1 else 257
    spec = logfbank(np.asarray(wav, np.float64), sample_rate, winlen=0.02,
                    winstep=0.01, nfilt=nfilt, nfft=1024)
    spec = spec.astype(np.float32).T[None, :, :]  # [1, nfilt, T]
    if z_normalize:
        spec = (spec - 1.93) / 17.89
    return spec


def slice_clip_pcm(wav: np.ndarray, fr_sec: float, num_sec: int = 1,
                   sample_rate: int = 48000,
                   use_volume_jittering: bool = False,
                   use_temporal_jittering: bool = False,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Host half of the device-spectrogram path: the clip slicing and
    waveform jitters of ``get_spec`` (same clamping, same draws), returning
    the raw [num_sec * sample_rate] float32 waveform for the card's
    log-filterbank (``ops/logmel.py``)."""
    if rng is None:
        rng = np.random.default_rng()
    if use_temporal_jittering:
        fr_sec = fr_sec + rng.uniform(-0.5, 0.5)
    clip = np.asarray(_clip_window(wav, fr_sec, num_sec, sample_rate),
                      np.float32)
    if use_volume_jittering:
        clip = clip * np.float32(rng.uniform(0.9, 1.1))
    return clip


def spec_num_frames(num_sec: int, sample_rate: int) -> int:
    """Spectrogram time dimension for a clip of ``num_sec`` seconds."""
    frame_len = _round_half_up(0.02 * sample_rate)
    frame_step = _round_half_up(0.01 * sample_rate)
    return frame_count(num_sec * sample_rate, frame_len, frame_step)
